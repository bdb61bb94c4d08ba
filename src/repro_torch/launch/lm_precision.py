"""How far bf16 rounding alone moves the port's LM logits, on one CUDA card.

The kernel-vs-plain checks of ``chip_smoke.py`` compare two correct float32
scans inside a bf16 model.  This script measures what such a comparison can
resolve, on the same random weights and prompts as ``chip_smoke.py``:

- the prefill logits with the kernel against the plain chunked path, in bf16;
- the noise floor: the plain path with its (decay, update) scans computed in
  float64 against float32, in bf16 (two correct roundings, no kernel);
- the hidden state after each layer, kernel against plain, in bf16 and in
  float32 (the weights upcast exactly), and each scan layer's mixer output on
  the SAME input (the plain run's), kernel against plain, in bf16;
- the float32 prefill logits, kernel against plain.

    PYTHONPATH=src python -m repro_torch.launch.lm_precision --arch rwkv6_3b

``--arch jamba_1_5_large_398b`` takes the one-group cut of ``chip_smoke.py``
(8 layers, dense FFNs).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import attention, init_params, layers, mamba, prefill, rwkv6


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def mixer(block, cfg, h, kernel: bool):
    if block.mixer_kind == "rwkv":
        return rwkv6.rwkv_tmix_forward(block.mixer, h, head_dim=cfg.rwkv_head_dim,
                                       use_kernel=kernel)
    if block.mixer_kind == "mamba":
        return mamba.mamba_forward(block.mixer, h, use_kernel=kernel)
    return attention.attn_forward(block.mixer, h, None, q_chunk=cfg.q_chunk,
                                  kv_chunk=cfg.kv_chunk)


def ffn(block, cfg, h):
    if block.ffn_kind == "mlp":
        return layers.apply_mlp(block.ffn, h, cfg.act)
    return rwkv6.rwkv_cmix_forward(block.ffn, h)


def hidden(params, cfg, tokens, kernel: bool) -> list:
    """The residual stream after every layer."""
    x, out = layers.embed(params.embed, tokens), []
    for block in params.blocks:
        x = x + mixer(block, cfg, layers.rmsnorm(block.norm1, x, cfg.eps), kernel)
        x = x + ffn(block, cfg, layers.rmsnorm(block.norm2, x, cfg.eps))
        out.append(x)
    return out


def same_input(params, cfg, tokens) -> list:
    """Each scan layer's mixer output, kernel against plain, on the plain
    run's input to that layer."""
    x, out = layers.embed(params.embed, tokens), []
    for block in params.blocks:
        h = layers.rmsnorm(block.norm1, x, cfg.eps)
        y = mixer(block, cfg, h, False)
        if block.mixer_kind in ("rwkv", "mamba"):
            out.append(rel(mixer(block, cfg, h, True), y))
        x = x + y
        x = x + ffn(block, cfg, layers.rmsnorm(block.norm2, x, cfg.eps))
    return out


def scans_in_float64(fn):
    """Run ``fn`` with the plain path's (decay, update) scans in float64."""
    orig = ref.linear_scan

    def scan64(a, b):
        return tuple(t.float() for t in orig(a.double(), b.double()))

    ref.linear_scan = mamba.linear_scan = scan64
    try:
        return fn()
    finally:
        ref.linear_scan = mamba.linear_scan = orig


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6_3b",
                    choices=("rwkv6_3b", "jamba_1_5_large_398b"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if cfg.moe is not None:      # chip_smoke.py's cut: one group, dense FFNs
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern), moe=None,
                                  pattern=tuple((m, "mlp") for m, _ in cfg.pattern))
    on = dataclasses.replace(cfg, rwkv_kernel=True, mamba_kernel=True)
    params = init_params(cfg, seed=args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab, (4, 1025), generator=gen, device="cuda")[:, :1024]
    print(torch.cuda.get_device_name(0), f"arch {args.arch}, {cfg.n_layers} layers, "
          "4 x 1024 tokens")

    k, _ = prefill(params, on, {"tokens": tokens})
    p, _ = prefill(params, cfg, {"tokens": tokens})
    p64, _ = scans_in_float64(lambda: prefill(params, cfg, {"tokens": tokens}))
    print(f"bf16 logits: kernel vs plain {rel(k, p):.3e}; plain with float64 scans vs "
          f"plain {rel(p64, p):.3e} (noise floor); argmax agreement kernel vs plain "
          f"{float((k.argmax(-1) == p.argmax(-1)).float().mean()):.2f}")
    print("bf16 hidden after each layer, kernel vs plain:",
          " ".join(f"{rel(a, b):.2g}" for a, b in zip(hidden(params, on, tokens, True),
                                                      hidden(params, cfg, tokens, False))))
    per = same_input(params, cfg, tokens)
    print(f"bf16 scan-layer output on the same input, kernel vs plain: max {max(per):.3e}")
    params.float()      # every bf16 value is exact in float32
    f32, f32_on = (dataclasses.replace(c, dtype="float32") for c in (cfg, on))
    k32, _ = prefill(params, f32_on, {"tokens": tokens})
    p32, _ = prefill(params, f32, {"tokens": tokens})
    print(f"float32 logits: kernel vs plain {rel(k32, p32):.3e}; bf16 plain vs float32 "
          f"plain {rel(p, p32):.3e}")
    print("float32 hidden after each layer, kernel vs plain:",
          " ".join(f"{rel(a, b):.2g}" for a, b in zip(hidden(params, f32_on, tokens, True),
                                                      hidden(params, f32, tokens, False))))


if __name__ == "__main__":
    main()
