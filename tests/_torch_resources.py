"""The two packages' accelerator vocabularies, for the tests that run both.

The reference counts TPU chips (``resources.tpu``, nodes of a TPU slice);
the port counts NVIDIA cards (``resources.gpu``, GPU hosts of an NVLink
domain, each with its card ids). A parity test builds each package's side
in its own words (``add_hosts``, ``in_vocab``) and compares the results
with the reference's mapped into the port's (``as_port``,
``text_as_port``).
"""

import re

REF = "kubeflow_tpu"


def add_hosts(pkg: str, cluster, name: str, num_hosts: int, per_host: int):
    """``num_hosts`` hosts named ``<name>-host-<i>`` of ``per_host``
    accelerators each: the reference's TPU slice, the port's NVLink
    domain of GPU hosts."""
    if pkg == REF:
        return cluster.add_tpu_slice(name, num_hosts, per_host)
    return cluster.add_gpu_hosts(name, num_hosts, per_host)


def in_vocab(pkg: str, obj):
    """``obj`` (a manifest written with ``tpu``) in ``pkg``'s words: the
    port's asks for ``gpu``."""
    return obj if pkg == REF else as_port(obj)


def as_port(obj):
    """A dump of the reference's objects in the port's words: ``tpu``
    becomes ``gpu``, ``slice_id`` ``nvlink_domain``, and an unset
    ``tpu_topology`` goes (the port has none)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "tpu_topology" and v is None:
                continue
            out[{"tpu": "gpu", "slice_id": "nvlink_domain"}.get(k, k)] = \
                as_port(v)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(as_port(v) for v in obj)
    return obj


def text_as_port(text: str) -> str:
    """A YAML or JSON text of the reference's objects in the port's words."""
    text = re.sub(r',? *"tpu_topology": null', "", text)
    text = re.sub(r"\n *tpu_topology: null", "", text)
    text = re.sub(r'(^|[\s{,])"tpu":', r'\1"gpu":', text)
    return re.sub(r"(^|\n)( *)tpu:", r"\1\2gpu:", text)


def as_ref(obj):
    """A dump of the port's objects in the reference's words, for the
    reference to replay: ``gpu`` becomes ``tpu``, ``nvlink_domain``
    ``slice_id``, and the card ids go (the reference has none)."""
    if isinstance(obj, dict):
        return {{"gpu": "tpu", "nvlink_domain": "slice_id"}.get(k, k):
                as_ref(v) for k, v in obj.items() if k != "device_ids"}
    if isinstance(obj, list):
        return [as_ref(v) for v in obj]
    return obj


def translate_store(src: str, dst: str, fn) -> str:
    """A copy at ``dst`` of the durable store at ``src`` (snapshot and
    log; the two packages' formats are one) with every object passed
    through ``fn`` (``as_ref``, ``as_port``); returns ``dst``."""
    import json
    import os

    from kubeflow_tpu_torch.controlplane import wal

    os.makedirs(dst, exist_ok=True)
    snap = os.path.join(src, wal.SNAP_NAME)
    if os.path.exists(snap):
        with open(snap) as f:
            image = json.load(f)
        image["objs"] = [fn(o) for o in image["objs"]]
        with open(os.path.join(dst, wal.SNAP_NAME), "w") as f:
            json.dump(image, f)
    with open(os.path.join(dst, wal.LOG_NAME), "wb") as f:
        for rec in wal.Wal(src)._read_log():
            if "obj" in rec:
                rec = {**rec, "obj": fn(rec["obj"])}
            f.write(wal._encode(rec))
    return dst
