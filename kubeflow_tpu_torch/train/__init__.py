"""Training loop, optimizer and data of the port."""
