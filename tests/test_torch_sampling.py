"""The port's sampling (``serving/continuous.py``: ``sample_filter`` and
``sample_draw``) against the reference's ``_sample_step``.

The filter (temperature, top-k, top-p, the banned token, greedy argmax) is
deterministic: its warped logits must equal the ones the reference hands to
``jax.random.categorical``, captured here by patching that call. The draw
comes from another generator than jax's, so it is held to the filtered
softmax in distribution (chi-square over 20,000 draws, fixed seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.serving import continuous as ref_cont


def _port():
    import torch

    from kubeflow_tpu_torch.serving import continuous

    torch.set_num_threads(1)
    return torch, continuous


def _logits(seed=0, slots=6, vocab=50):
    """Random f32 logits with planted ties: at the top of rows 0 and 1
    (argmax must take the first index) and at the k-th value of row 3."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((slots, vocab)).astype(np.float32) * 2
    x[0, 7] = x[0, 31] = x[0].max() + 1
    x[1, 2] = x[1, 40] = x[1].max() + 0.5
    order = np.argsort(-x[3])
    x[3, order[3]] = x[3, order[2]]          # a tie at the top-3 boundary
    return x


#: (temps, top_ps, top_ks): mixed greedy and sampled slots, top-k, top-p
KNOBS = {
    "mixed": ([0.0, 0.7, 1.0, 1.3, 0.5, 2.0], [1.0, 0.9, 0.5, 1.0, 0.3, 1.0],
              [0, 5, 0, 3, 50, 1]),
    "no_filter": ([0.0, 0.7, 1.0, 1.3, 0.0, 2.0], [1.0] * 6, [0] * 6),
    "top_k_only": ([1.0] * 6, [1.0] * 6, [1, 2, 3, 4, 60, 0]),
    "top_p_only": ([0.8] * 6, [0.05, 0.2, 0.5, 0.8, 0.95, 1.0], [0] * 6),
}


def _reference(logits, temps, top_ps, top_ks, banned, monkeypatch):
    """(the logits the reference samples from, its tokens with every
    sampled slot's draw replaced by -1)."""
    seen = {}

    def categorical(key, final, axis=-1):
        seen["final"] = np.asarray(final)
        return jnp.full(final.shape[:-1], -1, jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    toks = ref_cont._sample_step(
        jnp.asarray(logits), jnp.asarray(temps, jnp.float32),
        jnp.asarray(top_ps, jnp.float32), jnp.asarray(top_ks, jnp.int32),
        jax.random.PRNGKey(0),
        None if banned is None else jnp.asarray(banned, jnp.int32))
    return seen["final"], np.asarray(toks)


@pytest.mark.parametrize("banned", [None, [-1, 3, 0, -1, 12, 5]],
                         ids=["no_ban", "banned"])
@pytest.mark.parametrize("knobs", list(KNOBS))
def test_filter_matches_reference(knobs, banned, monkeypatch):
    torch, cont = _port()
    temps, top_ps, top_ks = KNOBS[knobs]
    logits = _logits()
    want_final, want_toks = _reference(logits, temps, top_ps, top_ks, banned,
                                       monkeypatch)
    filtered = any(k > 0 for k in top_ks) or any(p < 1 for p in top_ps)
    final, greedy = cont.sample_filter(
        torch.from_numpy(logits), torch.tensor(temps),
        torch.tensor(top_ps), torch.tensor(top_ks),
        None if banned is None else torch.tensor(banned),
        filtered=filtered)
    np.testing.assert_array_equal(final.numpy(), want_final)
    greedy_slots = np.asarray(temps) == 0
    np.testing.assert_array_equal(greedy.numpy()[greedy_slots],
                                  want_toks[greedy_slots])
    assert greedy[0] == 7 and greedy[1] == 2  # the first of each tie


@pytest.mark.parametrize("knobs", [
    (1.0, 1.0, 0), (0.7, 0.9, 0), (1.3, 1.0, 5), (1.0, 0.6, 6)],
    ids=["plain", "top_p", "top_k", "top_k_top_p"])
def test_draw_follows_filtered_softmax(knobs):
    from scipy import stats

    torch, cont = _port()
    temp, top_p, top_k = knobs
    n, vocab = 20_000, 8
    base = np.random.default_rng(5).standard_normal(vocab).astype(np.float32)
    logits = torch.from_numpy(np.tile(base, (n, 1)))
    temps = torch.full((n,), temp)
    final, greedy = cont.sample_filter(
        logits, temps, torch.full((n,), top_p),
        torch.full((n,), top_k, dtype=torch.int64), filtered=True)
    gen = torch.Generator().manual_seed(1234)
    noise = torch.rand(n, vocab, generator=gen)
    toks = cont.sample_draw(final, greedy, temps, noise).numpy()
    counts = np.bincount(toks, minlength=vocab)
    probs = torch.softmax(final[0].double(), -1).numpy()
    kept = probs > 0
    assert counts[~kept].sum() == 0, "a filtered-out token was drawn"
    assert kept.sum() >= 2
    p = stats.chisquare(counts[kept], probs[kept] / probs[kept].sum() * n
                        ).pvalue
    assert p > 1e-3, f"draws do not follow the filtered softmax: p={p}"


def test_greedy_slots_ignore_the_noise():
    torch, cont = _port()
    logits = torch.from_numpy(_logits(2))
    temps = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    final, greedy = cont.sample_filter(
        logits, temps, torch.ones(6), torch.zeros(6, dtype=torch.int64),
        filtered=False)
    a = cont.sample_draw(final, greedy, temps, torch.rand(6, 50))
    b = cont.sample_draw(final, greedy, temps, torch.rand(6, 50))
    keep = temps == 0
    assert torch.equal(a[keep], logits.argmax(-1)[keep])
    assert torch.equal(a[keep], b[keep])
