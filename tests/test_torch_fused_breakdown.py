"""``benchmarks/torch_fused_breakdown.py`` cuts parts out of kernel 1's
source by text edits; on the CPU, check that every cut still finds its
place in the source, so that a change to the kernel cannot leave the tool
timing the uncut kernel under a cut's name."""
import pytest

from benchmarks import torch_fused_breakdown as bd


def test_every_variant_applies_its_cuts():
    sources = bd.variant_sources()
    kernel = bd.SOURCE.read_text()
    assert sources["kernel"] == kernel
    for name, parts in bd.VARIANTS.items():
        for part in parts:
            for _, new in bd._CUTS[part]:
                assert new in sources[name], (name, part)
    cut = [sources[name] for name in bd.VARIANTS if name != "kernel"]
    assert len(set(cut)) == len(cut) and kernel not in cut


def test_a_cut_that_no_longer_matches_is_refused(monkeypatch):
    monkeypatch.setitem(bd._CUTS, "products", [("no such text in the kernel", "x")])
    with pytest.raises(ValueError, match="no longer matches"):
        bd.variant_sources()
