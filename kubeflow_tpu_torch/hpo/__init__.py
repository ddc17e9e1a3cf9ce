"""HPO plane of the port. Only the one-shot NAS supernet (``nas.py``) is
here so far; the Katib controllers, service, db and algorithms are ROADMAP
A15."""
