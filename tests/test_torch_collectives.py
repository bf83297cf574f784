"""Port parity: ``repro_torch.parallel.collectives`` against
``repro/parallel/collectives.py`` (the reference's cases of
``tests/test_collectives.py``, and the multi-rank ones on both sides).

The int8 payloads and scales of ``quantize_int8`` must equal the
reference's exactly on seeded inputs.  ``compressed_psum`` over 4 gloo
ranks (spawned processes) is held to the reference's under ``shard_map``
over the 4 simulated devices: the same payloads, summed in fp32 in
another order, so within 1e-6 relative.  ``maybe_psum`` sums an int32
block exactly over a bound group and is the identity without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as JP
from helpers.torch_dist import (compressed_grad_tree_ranks,
                                compressed_psum_ranks, psum_ranks, run_ranks)

import repro.parallel.collectives as J
import repro_torch.parallel as T
from repro.compat import shard_map
from repro_torch.parallel.collectives import BLOCK, bound_group, maybe_psum


def _inputs(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_exports_match_the_references():
    assert set(J.__all__) <= set(T.collectives.__all__)
    assert BLOCK == J.BLOCK == 256


def test_quantize_matches_the_reference_exactly():
    for seed, shape in ((0, (1000,)), (1, (8, 64)), (2, (3, 5, 7)),
                        (3, (256,))):
        x = _inputs(seed, shape)
        x[..., 0] = 0.0
        q, s, pad = T.quantize_int8(torch.from_numpy(x))
        jq, js, jpad = J.quantize_int8(jnp.asarray(x))
        assert pad == jpad
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.array_equal(s.numpy(), np.asarray(js))
        back = T.dequantize_int8(q, s, pad, x.shape).numpy()
        assert np.array_equal(back, np.asarray(
            J.dequantize_int8(jq, js, jpad, x.shape)))
    # an all-zero block: the scale's floor, as the reference's
    zeros = T.quantize_int8(torch.zeros(10))
    assert not zeros[0].any()
    assert np.array_equal(zeros[1].numpy(),
                          np.asarray(J.quantize_int8(jnp.zeros(10))[1]))


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(_inputs(0, (1000,)))
    q, s, pad = T.quantize_int8(x)
    err = (T.dequantize_int8(q, s, pad, x.shape) - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_compressed_psum_matches_the_references_shard_map(tmp_path):
    xs = [_inputs(10 + r, (8, 64)) for r in range(4)]
    got = run_ranks(compressed_psum_ranks, 4, tmp_path, xs)
    mesh = jax.make_mesh((4,), ("pod",))
    ref = shard_map(lambda v: J.compressed_psum(v[0], "pod")[None], mesh=mesh,
                    in_specs=JP("pod"), out_specs=JP("pod"),
                    check_vma=False)(jnp.asarray(np.stack(xs)))
    ref = np.asarray(ref)
    exact = np.sum(xs, axis=0)
    for r in range(4):
        np.testing.assert_allclose(got[r], ref[r], rtol=1e-6, atol=1e-6)
        assert np.array_equal(got[r], got[0])       # every rank: one sum
    # int8 error: at most half a step of each rank's block scale
    bound = sum(np.abs(x).max() for x in xs) / 127.0
    assert np.abs(got[0] - exact).max() <= bound


def test_compressed_psum_one_rank_is_the_identity_up_to_quantization(
        tmp_path):
    x = _inputs(1, (8, 64), scale=1.0)
    got, = run_ranks(compressed_psum_ranks, 1, tmp_path, [x])
    np.testing.assert_allclose(got, x, atol=float(np.abs(x).max()) / 120)


def test_maybe_psum_sums_int32_exactly_over_a_bound_group(tmp_path):
    rng = np.random.default_rng(3)
    xs = [rng.integers(-2 ** 28, 2 ** 28, (4, 31)).astype(np.int32)
          for _ in range(4)]
    for rank, (summed, other, unbound) in enumerate(
            run_ranks(psum_ranks, 4, tmp_path, xs)):
        assert summed.dtype == np.int32
        assert np.array_equal(summed, np.sum(xs, axis=0, dtype=np.int32))
        # an axis nothing is bound to, or nothing bound: the identity
        assert np.array_equal(other, xs[rank])
        assert np.array_equal(unbound, xs[rank])


def test_maybe_psum_without_a_group_is_the_identity():
    assert bound_group() is None
    x = torch.arange(6).reshape(2, 3)
    assert maybe_psum(x) is x
    assert maybe_psum(x, "pod") is x


def test_compressed_grad_tree_over_the_pod_dimension(tmp_path):
    trees = [{"w": _inputs(20 + r, (3, 100)), "b": _inputs(30 + r, (7,))}
             for r in range(4)]
    out = run_ranks(compressed_grad_tree_ranks, 4, tmp_path, trees)
    for rank, (tree, same, layout) in enumerate(out):
        assert same
        # the pod group of a (pod, model) mesh: the ranks of its column
        col = int(np.argwhere(layout == rank)[0][1])
        peers = layout[:, col].tolist()
        assert len(peers) == 2 and rank in peers
        for k in tree:
            want = sum(trees[p][k] for p in peers)
            bound = sum(np.abs(trees[p][k]).max() for p in peers) / 127.0
            assert np.abs(tree[k] - want).max() <= bound, (rank, k)
    grads = {"w": torch.ones(3)}
    assert T.compressed_grad_tree(grads, None) is grads


def test_error_feedback_matches_the_reference():
    g_np = _inputs(2, (512,), scale=0.1)
    g_true, jg = torch.from_numpy(g_np), jnp.asarray(g_np)
    residual = T.ErrorFeedback.init({"g": g_true})
    jres = J.ErrorFeedback.init({"g": jg})
    acc_ef, acc_plain = np.zeros(512), np.zeros(512)
    for _ in range(50):
        corrected, update = T.ErrorFeedback.apply({"g": g_true}, residual)
        jcorr, jupdate = J.ErrorFeedback.apply({"g": jg}, jres)
        np.testing.assert_allclose(corrected["g"].numpy(),
                                   np.asarray(jcorr["g"]), rtol=0, atol=0)
        q, s, pad = T.quantize_int8(corrected["g"])
        compressed = {"g": T.dequantize_int8(q, s, pad, g_true.shape)}
        jq, js, jpad = J.quantize_int8(jcorr["g"])
        residual = update(compressed)
        jres = jupdate({"g": J.dequantize_int8(jq, js, jpad, jg.shape)})
        np.testing.assert_array_equal(residual["g"].numpy(),
                                      np.asarray(jres["g"]))
        acc_ef += compressed["g"].numpy()
        qp, sp, pp = T.quantize_int8(g_true)
        acc_plain += T.dequantize_int8(qp, sp, pp, g_true.shape).numpy()
    target = g_np * 50
    assert np.abs(acc_ef - target).max() <= \
        np.abs(acc_plain - target).max() + 1e-5
    np.testing.assert_allclose(acc_ef, target, atol=0.02)
