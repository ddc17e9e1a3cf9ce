"""Serving runtimes: the predictors behind the builtin ServingRuntimes.

The port of ``kubeflow_tpu/serving/runtimes.py``, with the same names
where the framework allows:

- ``TorchFunctionModel`` (for the reference's ``JaxFunctionModel``): any
  ``fn(params, batch) -> batch`` on torch tensors, served under
  ``torch.inference_mode()`` at the fixed batch buckets the micro-batcher
  pads to.
- ``LlamaGenerator``: Llama weights -> greedy/temperature decode over the
  port model's ``KvCache`` decode path: one padded prefill of the
  micro-batch, then ``max_new_tokens`` single-token decode steps, the
  tokens kept on the device until one host fetch at the end.
- ``EchoModel``: trivial runtime for smoke tests and protocol conformance.
- ``BertClassifierModel``: BERT sequence classification (baseline config
  3, the ``kft-bert`` runtime) at fixed batch and sequence buckets, run
  eagerly under ``torch.inference_mode()``.

Every runtime's ``load`` puts its tensors on the CUDA card unless the config
says ``"device": "cpu"`` (``device.resolve_device``: no card raises).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama as llamalib
from .model import Model
from .storage import fetch_mem

#: batch buckets served; requests pad up to the next bucket
DEFAULT_BUCKETS = (1, 2, 4, 8)


def pad_to_bucket(n: int, buckets) -> int:
    """Smallest bucket >= n; clamps to the largest (callers that must
    reject oversize inputs check against buckets[-1] themselves)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _to_device(tree, device):
    """``tree`` (tensors in dicts, lists and tuples) with every tensor on
    ``device``; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


class EchoModel(Model):
    def predict_batch(self, instances):
        return instances


class TorchFunctionModel(Model):
    """Serve ``fn(params, batch_tensor) -> batch_tensor`` (f32).

    config:
      fn_ref:      "mem://key" holding (fn, params)  [or set via attributes]
      buckets:     batch buckets (default 1/2/4/8); a batch pads up to one
                   with zero rows, so ``fn`` only ever sees bucket shapes
      device:      "cpu" to serve on the CPU (default: the CUDA card)
    """

    def __init__(self, name: str, config: Optional[dict[str, Any]] = None):
        super().__init__(name, config)
        self.fn = self.config.get("fn")
        self.params = self.config.get("params")
        self.buckets = tuple(self.config.get("buckets", DEFAULT_BUCKETS))

    def load(self) -> None:
        ref = self.config.get("fn_ref")
        if ref:
            self.fn, self.params = fetch_mem(ref[len("mem://"):])
        if self.fn is None:
            raise RuntimeError(f"model {self.name}: no fn/fn_ref configured")
        self.device = resolve_device(self.config.get("device"))
        self.params = _to_device(self.params, self.device)
        self.ready = True

    def stop(self) -> None:
        self.params = None
        super().stop()

    def predict_batch(self, instances):
        x = np.asarray(instances, dtype=np.float32)
        out: list = []
        # chunk by the largest bucket, pad the tail to a bucket size
        cap = self.buckets[-1]
        for i in range(0, len(x), cap):
            chunk = x[i : i + cap]
            b = pad_to_bucket(len(chunk), self.buckets)
            padded = np.zeros((b, *chunk.shape[1:]), dtype=chunk.dtype)
            padded[: len(chunk)] = chunk
            with torch.inference_mode():
                y = self.fn(self.params,
                            torch.from_numpy(padded).to(self.device))
            out.extend(y[: len(chunk)].cpu().numpy().tolist())
        return out


class LlamaGenerator(Model):
    """Greedy/temperature text-token generation over Llama weights.

    config:
      params_ref:   "mem://key" holding (LlamaConfig, state dict)
      storage_path: a snapshot directory (``load_pretrained``) instead
      max_new_tokens (default 16), temperature (default 0 = greedy)
      seq_buckets:  prompt-length buckets (default powers of two from 32
                    below ``max_seq_len - max_new_tokens``, plus that cap)
      weights_dtype: cast every floating weight once at load (e.g.
                    "bfloat16": decode streams every weight per token)
      device:       "cpu" to serve on the CPU (default: the CUDA card)
      mesh_axes:    a tensor-parallel serving mesh: not ported (ROADMAP A7)

    Instances are token-id lists; predictions are continuation token lists.
    Ragged prompts batch together: the cache holds PER-ROW positions
    (``Attention._decode_attend``'s mask ``slot <= position``), so a
    mixed-length micro-batch pads to one seq bucket and runs as one prefill
    forward and ``max_new_tokens`` decode steps; pad junk past a row's length
    is masked out until that row's decode writes overwrite it.
    """

    def __init__(self, name: str, config: Optional[dict[str, Any]] = None):
        super().__init__(name, config)
        self.max_new_tokens = int(self.config.get("max_new_tokens", 16))
        self.temperature = float(self.config.get("temperature", 0.0))
        self.model: Optional[llamalib.Llama] = None
        self._req_counter = 0

    def load(self) -> None:
        if self.config.get("mesh_axes"):
            raise NotImplementedError(
                f"model {self.name}: mesh_axes (the sharded predictor, "
                "serving/sharded.py) is not ported yet (ROADMAP A7)")
        ref = self.config.get("params_ref")
        if ref:
            self.cfg, params = fetch_mem(ref[len("mem://"):])
        elif self.config.get("storage_path"):
            # serve a published snapshot (what save_pretrained writes and a
            # storage_uri resolves to): train -> publish -> serve
            self.cfg, params = llamalib.load_pretrained(
                self.config["storage_path"])
        else:
            raise RuntimeError(
                f"model {self.name}: need params_ref or storage_uri")
        n_new = self.max_new_tokens
        cap = self.cfg.max_seq_len - n_new
        if cap < 1:
            raise ValueError(
                f"max_new_tokens {n_new} leaves no room in max_seq_len "
                f"{self.cfg.max_seq_len}")
        default_buckets = [
            s for s in (32, 64, 128, 256, 512, 1024, 2048, 4096) if s < cap
        ] + [cap]
        raw = self.config.get("seq_buckets", default_buckets)
        # user buckets: sorted, deduped, clamped to what the cache can hold
        # (an oversized bucket would write KV past max_seq_len)
        valid = sorted({int(b) for b in raw if 1 <= int(b) <= cap})
        if not valid:
            raise ValueError(
                f"no usable seq bucket <= {cap} in {raw!r}")
        self.seq_buckets = tuple(valid)
        self.device = resolve_device(self.config.get("device"))
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()  # a registered model: its own copy
        model = llamalib.Llama(self.cfg, device=self.device)
        model.load_state_dict(params, strict=True)
        wd = self.config.get("weights_dtype")
        if wd:
            # once, here: the int8 leaves of a quantized model stay int8
            model.to(getattr(torch, str(wd)))
        self.model = model.eval()
        self._base_seed = int.from_bytes(os.urandom(4), "little")
        self.ready = True

    def stop(self) -> None:
        self.model = None
        super().stop()

    def _generator(self) -> torch.Generator:
        """The sampling noise of one request: temperature > 0 must differ
        across requests AND across replicas and restarts (a fixed seed made
        every "random" continuation identical; a bare counter would replay
        the same sequence on every replica) — the reference's
        ``fold_in(base_key, counter)``."""
        self._req_counter += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self._base_seed << 32) | self._req_counter)
        return gen

    def predict_batch(self, instances):
        """Ragged prompts batch together: pad to a shared seq bucket, one
        prefill and ``max_new_tokens`` decode steps whatever the length
        mix, then one host fetch of every row's tokens."""
        cap = self.seq_buckets[-1]
        # left-truncate over-long prompts (keep the tail — it conditions
        # the next token) instead of raising: one client's oversize prompt
        # must not fail the co-batched requests of others
        prompts = [list(map(int, inst))[-cap:] for inst in instances]
        # empty prompts get an EMPTY continuation: raising would fail the
        # co-batched requests of other clients, and fabricating output
        # conditioned on an arbitrary token would be indistinguishable
        # from a real answer.  They ride the batch as placeholder rows.
        empty = [i for i, p in enumerate(prompts) if not p]
        if len(empty) == len(prompts):
            return [[] for _ in prompts]  # nothing to decode: no dispatch
        prompts = [p if p else [0] for p in prompts]
        lengths = np.array([len(p) for p in prompts], np.int64)
        bucket = pad_to_bucket(int(lengths.max()), self.seq_buckets)
        batch = len(prompts)
        toks = np.zeros((batch, bucket), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        n_new = self.max_new_tokens
        # prefill positions < bucket, decode positions < bucket + n_new:
        # the cache holds (and the attention reads) that window only
        attend = min(bucket + n_new, self.cfg.max_seq_len)
        dev = self.device
        gen = self._generator() if self.temperature > 0 else None
        with torch.inference_mode():
            cache = llamalib.KvCache.zeros(self.cfg, batch, attend,
                                           device=dev)
            tok = torch.from_numpy(toks).to(dev)
            pos = torch.from_numpy(lengths).to(dev)
            logits = self.model(tok, cache=cache, attend=attend)
            logits = logits[torch.arange(batch, device=dev), pos - 1]
            out = torch.empty((batch, n_new), dtype=torch.long, device=dev)
            for i in range(n_new):
                out[:, i] = self._sample(logits, gen)
                if i + 1 < n_new:  # the last token's forward feeds nothing
                    step = self.model(out[:, i:i + 1], pos[:, None],
                                      cache=cache, attend=attend)
                    logits = step[:, -1]
                    pos = pos + 1
            rows = out.cpu().tolist()
        for i in empty:
            rows[i] = []
        return rows

    def _sample(self, logits, gen):
        """Greedy argmax, or a categorical draw at ``temperature`` as
        Gumbel-max over f32 logits (no host sync, unlike a multinomial)."""
        if self.temperature <= 0:
            return logits.argmax(-1)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return (logits.float() / self.temperature + gumbel).argmax(-1)


class BertClassifierModel(Model):
    """BERT sequence classification — baseline config 3's predictor
    ("KServe BERT-base InferenceService" -> the ``kft-bert`` runtime).

    config:
      params_ref:   "mem://key" holding (BertConfig, state dict or a
                    ``BertClassifier``)
      storage_path: a snapshot directory (``bert.load_pretrained``; either
                    package's ``save_pretrained`` layout) instead
      buckets:      batch buckets (default 1/2/4/8)
      seq_buckets:  sequence-length buckets (pad-up), default (32, 64, 128,
                    512) capped at ``max_position``
      device:       "cpu" to serve on the CPU (default: the CUDA card)

    Instances are token-id lists (ragged); predictions are per-class f32
    softmax probability lists. Padding tokens are masked out of attention,
    so a padded batch scores as each instance does alone; padding rows (a
    batch short of its bucket) attend nothing and stay finite.
    """

    def __init__(self, name: str, config: Optional[dict[str, Any]] = None):
        super().__init__(name, config)
        self.batch_buckets = tuple(self.config.get("buckets", DEFAULT_BUCKETS))
        self.model = None

    def load(self) -> None:
        from ..models import bert as bertlib

        ref = self.config.get("params_ref")
        if ref:
            self.cfg, params = fetch_mem(ref[len("mem://"):])
        elif self.config.get("storage_path"):
            self.cfg, params = bertlib.load_pretrained(
                self.config["storage_path"])
        else:
            raise RuntimeError(
                f"model {self.name}: need params_ref or storage_uri")
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()  # a registered model: its own copy
        self.device = resolve_device(self.config.get("device"))
        model = bertlib.BertClassifier(self.cfg, device=self.device)
        model.load_state_dict(params, strict=True)
        self.model = model.eval()
        default_buckets = [b for b in (32, 64, 128, 512)
                           if b <= self.cfg.max_position] or [
                               self.cfg.max_position]
        self.seq_buckets = tuple(
            self.config.get("seq_buckets", default_buckets))
        self.ready = True

    def stop(self) -> None:
        self.model = None
        super().stop()

    def predict_batch(self, instances):
        out: list = []
        cap = self.batch_buckets[-1]
        for i in range(0, len(instances), cap):
            chunk = instances[i : i + cap]
            b = pad_to_bucket(len(chunk), self.batch_buckets)
            s = pad_to_bucket(max(len(x) for x in chunk), self.seq_buckets)
            ids = np.zeros((b, s), np.int64)
            mask = np.zeros((b, s), np.bool_)
            for j, toks in enumerate(chunk):
                toks = toks[:s]
                ids[j, : len(toks)] = toks
                mask[j, : len(toks)] = True
            with torch.inference_mode():
                logits = self.model(torch.from_numpy(ids).to(self.device),
                                    torch.from_numpy(mask).to(self.device))
                probs = logits.float().softmax(dim=-1).cpu().numpy()
            out.extend(probs[: len(chunk)].tolist())
        return out
