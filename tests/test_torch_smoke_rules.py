"""``chip_smoke.py``'s rules for holding the card's decoded tokens and beam
score to the CPU's, checked on the host: the sampled decode's tie rule (a
first difference passes only where the CPU's noisy scores of the two
tokens nearly tie, and never at a token below the top-k) and the beam
score's fp64 and fp32 paths."""

import numpy as np
import pytest
import torch

from aesara_tpu_torch.config import config
from aesara_tpu_torch.tensor.random.op import prng_key
from tests.test_torch_sparse import _chip_smoke

TOP_K = 40


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


def _step(smoke, top_k):
    """Logits of one step, the key of its draw, and the CPU's scores."""
    logits = np.random.default_rng(5).normal(0.0, 3.0, smoke.DEC_VOCAB)
    key = prng_key(11)
    return logits, key, smoke.noisy_scores(logits, smoke.gumbel_uniforms(key), top_k)


@pytest.mark.parametrize("top_k", [0, TOP_K])
def test_the_sampled_tie_rule_passes_equal_tokens_and_a_tie(smoke, top_k):
    logits, key, scores = _step(smoke, top_k)
    first, second = np.argsort(scores)[::-1][:2]
    # lift the runner-up's logit until its noisy score is a hair under the best's
    logits[second] += (scores[first] - scores[second] - 1e-6) * smoke.SAMPLE_T
    oracle = lambda toks: logits
    assert smoke.sample_tie_rule("t", [first, 5], [first, 5], [17], oracle, key, top_k) == 2
    assert smoke.sample_tie_rule("t", [second, 5], [first, 6], [17], oracle, key, top_k) == 0


@pytest.mark.parametrize("top_k", [0, TOP_K])
def test_the_sampled_tie_rule_refuses_a_token_that_does_not_tie(smoke, top_k):
    logits, key, scores = _step(smoke, top_k)
    kept = np.flatnonzero(np.isfinite(scores))
    best, worst = kept[np.argmax(scores[kept])], kept[np.argmin(scores[kept])]
    with pytest.raises(AssertionError, match="not a tie"):
        smoke.sample_tie_rule("t", [17, worst], [17, best], [17], lambda toks: logits, prng_key(11), top_k)


def test_the_sampled_tie_rule_refuses_a_token_below_the_top_k(smoke):
    """Below the top-k the graph's logits are -1e9; a scale taken over them
    made every first difference a tie.  A masked token never ties, even one
    whose unmasked noisy score is the runner-up's."""
    logits, key, scores = _step(smoke, TOP_K)
    best = int(np.argmax(scores))
    unmasked = smoke.noisy_scores(logits, smoke.gumbel_uniforms(key), 0)
    masked = np.flatnonzero(~np.isfinite(scores))
    planted = int(masked[np.argmax(unmasked[masked])])
    with pytest.raises(AssertionError, match="not a tie"):
        smoke.sample_tie_rule("t", [planted], [best], [17], lambda toks: logits, key, TOP_K)


def test_the_noisy_scores_are_the_graphs_draw(smoke):
    """The rule's uniforms are the sampled graph's: JAX's float64 uniforms
    of the key's draw moved onto [1e-6, 1 - 1e-6] in float32."""
    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_plain

    key = prng_key(11)
    u = smoke.gumbel_uniforms(key)
    raw = threefry_plain(torch.as_tensor(key), (smoke.DEC_VOCAB,), "float64")[1].numpy()
    assert u.dtype == np.float32 and u.shape == (smoke.DEC_VOCAB,)
    assert 1e-6 <= u.min() and u.max() <= 1.0 - 1e-6
    np.testing.assert_allclose(u, raw, atol=2e-6)


def test_the_beam_scores_fp64_path_is_the_log_softmax_sum_and_the_fp32_path_is_not(smoke):
    rng = np.random.default_rng(9)
    steps = [rng.normal(0.0, 3.0, 1000) for _ in range(8)]
    toks = [int(rng.integers(1000)) for _ in steps]
    prompt = np.arange(4, dtype="int64")
    oracle = lambda seq: steps[len(seq) - len(prompt)]
    s64, s32 = smoke.path_scores(oracle, prompt, toks)
    want = sum(float(torch.log_softmax(torch.as_tensor(l), 0)[t]) for l, t in zip(steps, toks))
    assert abs(s64 - want) <= 1e-12 * abs(want)
    assert s32 != s64 and abs(s32 - s64) <= 1e-5 * abs(want)
