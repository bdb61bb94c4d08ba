"""The form of the encode kernel (kernel 4), chosen on the CPU.

``coded_fused.encode_width(itemsize, cols, *operands)`` picks the form the
wrapper of ``csrc/coded_encode.cu`` launches: 16 (16-byte loads and
stores of 8 bf16/f16 elements) where the layout allows it, else the
element size (one element a thread).  It is a pure function of the
operands' data pointer, block offsets and row stride (the tuple
``ops.encode`` hands the kernel), so the card is not needed to pin it.
The views are meta tensors: only their shapes and strides count.
"""
import pytest
import torch

from repro_torch.core.partition import block_decompose
from repro_torch.kernels.coded_fused import _block_offsets, encode_width

BASE = 1 << 40   # a data pointer as the caching allocator gives (512-byte aligned)
HALF = [torch.bfloat16, torch.float16]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _form(view: torch.Tensor, ptr: int = BASE) -> int:
    """The form ops.encode launches for ``view``: blocks (*grid, rows,
    cols), or the flat (P, E) form, which it passes as (P, 1, E)."""
    x = view.unsqueeze(1) if view.ndim == 2 else view
    offsets, row_stride = _block_offsets(x)
    return encode_width(x.element_size(), x.shape[-1], (ptr, list(offsets), row_stride))


@pytest.mark.parametrize("grid", [(2, 2), (2, 1), (4, 2)])
@pytest.mark.parametrize("dtype", HALF)
def test_paper_block_views_take_the_16_byte_form(grid, dtype):
    """The paper's 8000^2 operands cut into strided 4000-wide block views
    (row stride 8000, block offsets multiples of 4000)."""
    view = block_decompose(_meta(8000, 8000, dtype=dtype), *grid)
    assert view.stride(-2) == 8000
    assert _form(view) == 16


@pytest.mark.parametrize("E", [8, 1000, 2048, 16_000_000])
def test_flat_form_with_e_a_multiple_of_8_takes_16(E):
    assert _form(_meta(4, E)) == 16


@pytest.mark.parametrize("E", [1, 7, 1004, 16_000_001])
def test_flat_form_with_e_off_8_takes_one_element(E):
    assert _form(_meta(4, E)) == 2


@pytest.mark.parametrize("stride", [65, 66, 68, 71])
def test_row_stride_off_16_bytes_takes_one_element(stride):
    """cols = 64 (a multiple of 8) in rows whose stride is no 16-byte
    multiple."""
    view = _meta(4, 9, stride)[..., :64]
    assert view.stride(-2) == stride
    assert _form(view) == 2
    assert _form(_meta(4, 9, 72)[..., :64]) == 16


@pytest.mark.parametrize("offset", [1, 2, 4, 6, 12])
def test_block_offset_off_16_bytes_takes_one_element(offset):
    assert encode_width(2, 64, (BASE, [0, 64 * 9 + offset, 2 * 64 * 9], 64)) == 2
    assert encode_width(2, 64, (BASE, [0, 64 * 9 + 8, 2 * 64 * 9], 64)) == 16


@pytest.mark.parametrize("shift", [2, 4, 8, 14])
def test_pointer_off_16_bytes_takes_one_element(shift):
    view = block_decompose(_meta(64, 128), 2, 2)
    assert _form(view, BASE + shift) == 2
    assert _form(view, BASE + 16) == 16


@pytest.mark.parametrize("cols", [1, 4, 60, 4001])
def test_cols_off_8_with_aligned_inputs_takes_one_element(cols):
    """Aligned pointer, offsets and row stride, but rows of the
    contiguous output would not all start on 16 bytes."""
    view = _meta(4, 9, 4096)[..., :cols]
    assert _form(view) == 2


@pytest.mark.parametrize("dtype,itemsize", [(torch.float64, 8), (torch.float32, 4)])
def test_float64_and_float32_take_the_one_element_kernel(dtype, itemsize):
    view = block_decompose(_meta(8000, 8000, dtype=dtype), 2, 2)
    assert _form(view) == itemsize
    assert _form(_meta(4, 2048, dtype=dtype)) == itemsize
    assert encode_width(itemsize, 4000, (BASE, [0, 4000], 8000)) == itemsize
