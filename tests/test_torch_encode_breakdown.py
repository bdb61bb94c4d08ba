"""``benchmarks/torch_encode_breakdown.py`` edits kernel 4's source by text;
on the CPU, check that every edit still finds its place in the source, so
that a change to the kernel cannot leave the tool timing the unedited
kernel under a variant's name."""
import pytest

from benchmarks import torch_encode_breakdown as bd


def test_every_variant_applies_its_edits():
    sources = bd.variant_sources()
    kernel = bd.SOURCE.read_text()
    assert set(sources) == set(bd.VARIANTS) and sources["kernel"] == kernel
    for name, edits in bd._EDITS.items():
        for _, new in edits:
            assert new in sources[name], name
    edited = [sources[name] for name in bd._EDITS]
    assert len(set(edited)) == len(edited) and kernel not in edited


@pytest.mark.parametrize("variant", sorted(bd._EDITS))
def test_an_edit_that_no_longer_matches_is_refused(monkeypatch, variant):
    monkeypatch.setitem(bd._EDITS, variant, [("no such text in the kernel", "x")])
    with pytest.raises(ValueError, match="no longer matches"):
        bd.variant_sources()
