"""What each rank runs for the port's serving-gang tests
(``tests/test_torch_sharded.py``, ``tests/test_torch_gang.py``,
``tests/test_torch_resize.py``).

A module of its own (no jax, no test collection) so that the processes
``parallel.dryrun.spawn`` starts import only torch and the port. Each
``run_*`` executes every case of one test file on one rank, in one spawn,
and returns that rank's results; the test files hold them against the
reference and against one unsharded process.

Rank 0 serves through a ``GangEngine`` (the scheduler, every decision
published over a ``GangChannel``); rank 1 ``follow``s. Both record the
output tensor of every program they run, so a test can hold the
follower's tokens bitwise against rank 0's.
"""

from __future__ import annotations

TOKEN = "gang-test-token"
WAIT_S = 120


def _setup():
    import torch

    torch.set_num_threads(1)
    return torch


def _cfg(cfg_kw: dict):
    from kubeflow_tpu_torch.models import llama

    return llama.tiny(**cfg_kw)


def _record(outs: list, key, out) -> None:
    import torch

    if isinstance(out, torch.Tensor):
        outs.append((tuple(key), out.detach().clone()))


def _leader(port: int, cfg, sd, kw: dict, outs: list):
    from kubeflow_tpu_torch.serving.gang import GangChannel, GangEngine

    ch = GangChannel.listen(port, 1, token=TOKEN, timeout=60)
    eng = GangEngine(cfg, sd, channel=ch, device="cpu", **kw)
    inner = eng._dispatch.run

    def run(key, build, host):
        out = inner(key, build, host)
        _record(outs, key, out)
        return out

    eng._dispatch.run = run
    return eng


def _follow(port: int, cfg, sd, kw: dict) -> dict:
    """Rank 1: follow the leader's stream to its ``stop``. With a
    ``program_cache`` in ``kw``, ``"aot"`` holds its stats at each engine
    a resize hands over and at the end."""
    from kubeflow_tpu_torch.serving import continuous
    from kubeflow_tpu_torch.serving.gang import GangChannel, follow

    ch = GangChannel.connect("127.0.0.1", port, rank=1, token=TOKEN,
                             timeout=60)
    eng = continuous.ContinuousEngine(cfg, sd, device="cpu", **kw)
    outs: list = []
    inner = eng.replay

    def replay(key, host):
        out = inner(key, host)
        _record(outs, key, out)
        return out

    eng.replay = replay
    cache = kw.get("program_cache")
    aot: list = []

    def on_engine(new):
        if cache is not None:
            aot.append(cache.stats())

    try:
        follow(eng, ch, on_engine=on_engine)
    finally:
        ch.close()
    on_engine(None)
    return {"outs": outs, "pool_heads": int(eng._pool.k.shape[3]),
            "kv_pool_bytes": eng.kv_pool_bytes, "aot": aot}


def _serve(eng, prompts, new, warm) -> dict:
    try:
        eng.warmup([tuple(g) for g in warm])
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        tokens = [r.wait(WAIT_S) for r in reqs]
        stats = eng.stats()
    finally:
        eng.stop()
    pool = getattr(eng, "_pool", None)
    return {"tokens": tokens, "stats": stats,
            "pool_heads": None if pool is None else int(pool.k.shape[3]),
            "kv_pool_bytes": getattr(eng, "kv_pool_bytes", None)}


def gang_case(rank: int, port: int, cfg_kw: dict, sd: dict, kw: dict,
              prompts: list, new: int, warm: list) -> dict:
    """One greedy serving run of ``prompts`` through a gang of two ranks
    at ``{"model": 2}``."""
    cfg = _cfg(cfg_kw)
    kw = {"mesh_axes": {"model": 2}, **kw}
    if rank:
        return _follow(port, cfg, sd, kw)
    outs: list = []
    eng = _leader(port, cfg, sd, kw, outs)
    return {**_serve(eng, prompts, new, warm), "outs": outs,
            "backend": eng.backend, "graphs": eng.graphs}


def forward_logits(rank: int, cfg_kw: dict, sd: dict, tokens) -> "object":
    """The full-sequence logits of ``tokens`` through the model laid out at
    ``{"model": 2}`` (every rank gets the gathered logits)."""
    torch = _setup()
    from kubeflow_tpu_torch.serving import sharded

    cfg = _cfg(cfg_kw)
    mesh = sharded.build_serving_mesh({"model": 2})
    model = sharded.place_params(cfg, sd, mesh, torch.device("cpu"))
    with torch.no_grad():
        return model(torch.tensor(tokens)).float().numpy()


def generator_tokens(sd: dict, prompts: list, new: int) -> list:
    """``LlamaGenerator`` at ``{"model": 2}``: every rank loads it and
    predicts the same instances."""
    from kubeflow_tpu_torch.serving.runtimes import LlamaGenerator
    from kubeflow_tpu_torch.serving.storage import register_mem

    ref = register_mem("gang-generator", (_cfg({}), sd))
    gen = LlamaGenerator("g", {"params_ref": ref, "device": "cpu",
                               "max_new_tokens": new,
                               "mesh_axes": {"model": 2}})
    gen.start()
    try:
        return gen.predict_batch(prompts)
    finally:
        gen.stop()


def module_engine(sd: dict) -> dict:
    """An unsharded ``Llama`` handed to an engine with ``mesh_axes``: the
    engine lays it out over the group, this rank's heads only."""
    from kubeflow_tpu_torch.models.llama import Llama
    from kubeflow_tpu_torch.serving import continuous

    cfg = _cfg({})
    model = Llama(cfg, device="cpu")
    model.load_state_dict(sd)
    eng = continuous.ContinuousEngine(cfg, model, device="cpu",
                                      mesh_axes={"model": 2}, num_slots=2)
    try:
        return {"tp_degree": eng.tp_degree, "kv_heads": eng.kv_heads,
                "laid_out": eng.model is not model}
    finally:
        eng.stop()


def run_sharded(rank: int, ports: list, cases: dict, sd: dict,
                prompts: list, new: int, warm: list,
                case_sds: dict | None = None) -> dict:
    """``tests/test_torch_sharded.py``: the logits of a forward pass, the
    ``LlamaGenerator``'s tokens, and one gang run per engine variant
    (``cases``: name -> (cfg kwargs, engine kwargs)), on ``sd`` or the
    case's own weights in ``case_sds`` (int8 ones, say)."""
    _setup()
    out = {"logits": forward_logits(rank, {}, sd, [prompts[2]]),
           "generator": generator_tokens(sd, prompts, new),
           "module_engine": module_engine(sd)}
    for (name, (cfg_kw, kw)), port in zip(cases.items(), ports):
        out[name] = gang_case(rank, port, cfg_kw,
                              (case_sds or {}).get(name, sd), kw, prompts,
                              new, warm)
    return out


def _wire_case(rank: int, port: int, sd: dict, prompt: list, new: int,
               warm: list, cut: int) -> dict:
    """A live sequence exported from the gang at TP=2 after ``cut``
    tokens, imported into an unsharded engine on rank 0 through the
    kv_migrate wire (``KvMigrationServer``), where it finishes."""
    import time

    from kubeflow_tpu_torch.serving import continuous
    from kubeflow_tpu_torch.serving.gang import (
        KvMigrationServer,
        migrate_sequence,
        register_migration_handle,
    )

    cfg = _cfg({})
    kw = {"mesh_axes": {"model": 2}, "num_slots": 2, "decode_chunk": 1,
          "block_size": 8, "prefix_cache": False}
    if rank:
        return _follow(port, cfg, sd, kw)
    outs: list = []
    gang = _leader(port, cfg, sd, kw, outs)
    dst = continuous.ContinuousEngine(
        cfg, sd, device="cpu", num_slots=2, decode_chunk=1, block_size=8,
        prefix_cache=False)
    srv = KvMigrationServer(dst, token=TOKEN)
    try:
        gang.warmup([tuple(g) for g in warm])
        dst.warmup([tuple(g) for g in warm])
        req = gang.submit(prompt, max_new_tokens=new)
        deadline = time.monotonic() + WAIT_S
        while len(req.tokens) < cut and time.monotonic() < deadline:
            time.sleep(0.005)
        snap = gang.export_sequence(req)
        heads = int(snap["blocks"][0][0].shape[3])
        # the destination resolves the handle from the migration id, so
        # the stream goes on on it
        ok = migrate_sequence(snap, "127.0.0.1", srv.port, token=TOKEN,
                              mid=register_migration_handle(req))
        gang.release_sequence(req)
        tail = req.wait(WAIT_S)
        return {"ok": ok, "head": list(snap["generated"]), "tail": tail,
                "snapshot_heads": heads, "imports": srv.imports_total,
                "dst_stats": dst.stats(), "src_stats": gang.stats()}
    finally:
        srv.close()
        dst.stop()
        gang.stop()


def run_gang(rank: int, ports: list, cases: dict, sd: dict, prompts: list,
             new: int, warm: list, wire: dict) -> dict:
    """``tests/test_torch_gang.py``: one gang run per schedule (``cases``:
    name -> engine kwargs), then the kv_migrate wire case."""
    _setup()
    out = {}
    for (name, kw), port in zip(cases.items(), ports):
        out[name] = gang_case(rank, port, {}, sd, kw, prompts, new, warm)
    out["wire"] = _wire_case(rank, ports[-1], sd, **wire)
    return out


def _wait_tokens(req, n: int) -> None:
    import time

    deadline = time.monotonic() + WAIT_S
    while len(req.tokens) < n and time.monotonic() < deadline:
        if req.done.is_set():
            raise RuntimeError(f"request finished at {len(req.tokens)} "
                               f"tokens, before {n}")
        time.sleep(0.002)


def _idle_free(eng) -> tuple[int, int]:
    """(free blocks, total) once the engine has retired everything."""
    import time

    deadline = time.monotonic() + 30
    while (eng._alloc.free_blocks < eng.num_blocks
           and time.monotonic() < deadline):
        time.sleep(0.01)
    return eng._alloc.free_blocks, eng.num_blocks


def run_resize(rank: int, port: int, sd: dict, prompt: list, new: int,
               warm: list, aot_root=None) -> dict:
    """``tests/test_torch_resize.py``: a live TP=2 gang; a resize killed
    mid-export (resumes in place); then, with a stream open, a shrink to
    1 and a grow back to 2. ``aot_root``: every rank's engines share a
    program-artifact cache there; rank 0's ``"aot"`` holds its stats
    before and after the grow."""
    _setup()
    from kubeflow_tpu_torch.serving import programs
    from kubeflow_tpu_torch.serving.resize import GangResizer, ResizeAborted

    cfg = _cfg({})
    kw = {"mesh_axes": {"model": 2}, "num_slots": 2, "decode_chunk": 1,
          "block_size": 8, "prefix_cache": False}
    if aot_root is not None:
        kw["program_cache"] = programs.ProgramArtifactCache(aot_root,
                                                            fsync=False)
    if rank:
        return _follow(port, cfg, sd, kw)
    outs: list = []
    eng = _leader(port, cfg, sd, kw, outs)
    out: dict = {}
    eng.warmup([tuple(g) for g in warm])

    for phase in ("export", "commit"):
        # killed mid-export (nothing published yet), then mid-commit (the
        # group re-formed at degree 1 and formed again at 2 by the abort)
        def kill(at, _phase=phase):
            if at == _phase:
                raise RuntimeError(f"chaos: resize killed mid-{at}")

        aborted = GangResizer(eng, reshard_token=TOKEN, failpoint=kill,
                              warmup_groups=warm)
        req = eng.submit(prompt, max_new_tokens=new)
        _wait_tokens(req, 2)
        try:
            aborted.resize({"model": 1})
            got = None
        except ResizeAborted as e:
            got = e.phase
        out[f"abort_{phase}"] = {
            "phase": got, "failures": aborted.resize_failures_total,
            "tokens": req.wait(WAIT_S), "free": _idle_free(eng),
            "tp_degree": eng.tp_degree}

    resizer = GangResizer(eng, reshard_token=TOKEN, warmup_groups=warm)
    req = eng.submit(prompt, max_new_tokens=new)
    _wait_tokens(req, 3)
    one = resizer.resize({"model": 1})
    out["shrunk"] = {"tp_degree": one.tp_degree, "graphs": one.graphs,
                     "timings": dict(resizer.last_timings),
                     "at": len(req.tokens)}
    _wait_tokens(req, len(req.tokens) + 3)
    cache = kw.get("program_cache")
    if cache is not None:
        out["aot"] = [cache.stats()]
    two = resizer.resize({"model": 2})
    if cache is not None:
        out["aot"].append(cache.stats())
    out["grown"] = {"tp_degree": two.tp_degree,
                    "timings": dict(resizer.last_timings),
                    "at": len(req.tokens)}
    out["tokens"] = req.wait(WAIT_S)
    out["free"] = _idle_free(two)
    out["stats"] = two.stats()
    out["resizes"] = resizer.resizes_total
    two.stop()
    return out
