"""The port's integer-grid gradient compression against the JAX package.

``tests/test_distributed_extras.py::TestCompression``'s four cases, each
with the same float32 inputs through both packages (quantised ints, scales
and dequantised values equal bit for bit), plus ``compressed_psum`` on a
4-rank CPU group (gloo): the integer all-reduce equals the sum of the
ranks' quantised gradients, whatever order the ranks add in.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.distributed.compression import dequantize_tree as jdequantize_tree
from repro.distributed.compression import error_feedback_update as jerror_feedback_update
from repro.distributed.compression import quantize_tree as jquantize_tree
from repro_torch.distributed.compression import (
    compressed_psum,
    dequantize_tree,
    error_feedback_update,
    quantize_tree,
)
from repro_torch.launch.mesh import spawn_mesh

RANKS = 4
BITS = (8, 15)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float32))


class TestCompression:
    def test_quantize_roundtrip_accuracy(self, rng):
        g = rng.normal(size=(64, 64)).astype(np.float32)
        q, s = quantize_tree({"w": _t(g)}, bits=15)
        back = dequantize_tree(q, s)
        rel = float((back["w"] - _t(g)).abs().max() / _t(g).abs().max())
        assert rel < 1e-3
        assert q["w"].dtype == torch.int32
        jq, js = jquantize_tree({"w": _j(g)}, bits=15)
        np.testing.assert_array_equal(q["w"].numpy(), np.asarray(jq["w"]))
        assert float(s["w"]) == float(js["w"])
        np.testing.assert_array_equal(back["w"].numpy(),
                                      np.asarray(jdequantize_tree(jq, js)["w"]))

    def test_scale_is_power_of_two(self, rng):
        g = rng.normal(size=(32,)).astype(np.float32)
        _, s = quantize_tree({"w": _t(g)}, bits=15)
        l2 = float(torch.log2(s["w"]))
        assert l2 == int(l2)
        _, js = jquantize_tree({"w": _j(g)}, bits=15)
        assert float(s["w"]) == float(js["w"])

    def test_error_feedback_unbiased(self, rng):
        """Sum of EF-compressed grads converges to sum of true grads, and
        each step equals the reference's."""
        true_sum = np.zeros(16, np.float32)
        ef_sum = np.zeros(16, np.float32)
        res = jres = None
        for _ in range(50):
            g = rng.normal(size=16).astype(np.float32)
            true_sum += g
            deq, res = error_feedback_update({"w": _t(g)}, res, bits=6)
            jdeq, jres = jerror_feedback_update({"w": _j(g)}, jres, bits=6)
            np.testing.assert_array_equal(deq["w"].numpy(), np.asarray(jdeq["w"]))
            np.testing.assert_array_equal(res["w"].numpy(), np.asarray(jres["w"]))
            ef_sum += deq["w"].numpy()
        gap = np.abs(true_sum - ef_sum).max()
        assert gap <= float(res["w"].abs().max()) + 1e-5

    def test_int_sum_exact_across_orders(self, rng):
        """The point of the integer grid: order-independent reduction."""
        g = [rng.normal(size=8).astype(np.float32) for _ in range(5)]
        qs = [quantize_tree({"w": _t(x)}, bits=12) for x in g]
        scale = max(float(s["w"]) for _, s in qs)
        assert scale == max(float(jquantize_tree({"w": _j(x)}, bits=12)[1]["w"]) for x in g)
        ints = [np.round(x / scale).astype(np.int64) for x in g]
        np.testing.assert_array_equal(sum(ints), sum(reversed(ints)))


def _grads(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"w": torch.as_tensor(rng.normal(size=(6, 5)).astype(np.float32)),
            "layer": {"b": torch.as_tensor(rng.normal(size=7).astype(np.float32) * 10)}}


def _psum_rank(mesh) -> dict:
    grads = _grads(mesh.get_local_rank("model"))
    return {bits: compressed_psum(grads, mesh.get_group("model"), bits=bits)
            for bits in BITS}


@pytest.fixture(scope="module")
def psum_ranks():
    outs = spawn_mesh(_psum_rank, data=1, model=RANKS, device="cpu", timeout_s=120)
    return [out.result for out in outs]


@pytest.mark.parametrize("bits", BITS)
def test_compressed_psum_on_four_ranks(psum_ranks, bits):
    outs = [rank[bits] for rank in psum_ranks]
    grads = [_grads(r) for r in range(RANKS)]
    for path in (("w",), ("layer", "b")):
        def leaf(tree):
            for key in path:
                tree = tree[key]
            return tree

        # the synchronised scale is the largest rank's power-of-two scale
        scale = max(float(leaf(quantize_tree(g, bits)[1])) for g in grads)
        want = sum(np.round(leaf(g).numpy() / scale).astype(np.int64) for g in grads)
        for out in outs:
            got = leaf(out)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), (want * scale).astype(np.float32))
        # close to the float sum, within one grid step per rank
        exact = sum(leaf(g).numpy().astype(np.float64) for g in grads)
        assert np.abs(leaf(outs[0]).numpy() - exact).max() <= RANKS * scale / 2 + 1e-6
