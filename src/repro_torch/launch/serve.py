"""LM serving entry point: batched prefill + greedy decode with a state cache.

Prefills a batch of prompts, then greedy-decodes ``--gen`` tokens per
prompt (the first from the prefill's logits, each later one from a decode
step).  Runs on the CUDA card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b --smoke \\
      --batch 4 --prompt-len 32 --gen 16 --device cpu

It serves every architecture of ``configs.list_archs()`` (``--smoke`` for
the reduced configs).  Weights are random, from a ``torch.Generator``
seeded with ``--seed`` on the device.  The embedding-input configs
(``musicgen_medium``, ``qwen2_vl_72b``) take the reference CLI's stubbed
frontend: token ids become fixed pseudo-embeddings (:func:`_make_batch`).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.numerics import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import ModelConfig, init_params

__all__ = ["generate", "main", "stub_embeds"]


def stub_embeds(tokens: torch.Tensor, d: int) -> torch.Tensor:
    """The frontend stub of the embedding-input configs (it stands in for
    EnCodec frames or ViT patches): token ids (B, S) -> the pseudo-embeddings
    ``sin(tok * 0.01 + arange(d) * 0.1) * 0.1`` (B, S, d), float32 math
    rounded to bf16."""
    base = torch.arange(d, dtype=torch.float32, device=tokens.device)
    return (torch.sin(tokens[..., None].float() * 0.01 + base * 0.1) * 0.1).to(torch.bfloat16)


def _make_batch(cfg: ModelConfig, tokens: torch.Tensor) -> dict:
    """The model input for token ids (B, S), as the reference CLI makes it:
    the tokens themselves, or for embedding input their
    :func:`stub_embeds`, with ``pos_ids`` all zeros (3, B, S) int32 for
    multimodal rope (decode adds the position)."""
    if cfg.input_mode == "tokens":
        return {"tokens": tokens}
    B, S = tokens.shape
    out = {"embeds": stub_embeds(tokens, cfg.d_model)}
    if cfg.pos == "mrope":
        out["pos_ids"] = torch.zeros((3, B, S), dtype=torch.int32, device=tokens.device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ModelConfig, params, prompts: torch.Tensor, gen: int) -> tuple:
    """Greedy generation: prompts (B, S) int on the parameters' device ->
    (tokens (B, gen) int64, {"prefill_s", "decode_s", "decode_steps"}).

    The first token comes from the prefill's last logits, each of the other
    ``gen - 1`` from one decode step; the attention cache holds S + gen
    positions.  Times are host seconds around work ended by a synchronize.
    """
    B, S = prompts.shape
    prefill_fn = make_prefill_step(cfg, S_max=S + gen)
    serve_fn = make_serve_step(cfg)
    dev = prompts.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, _make_batch(cfg, prompts))
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = [logits.argmax(-1)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = serve_fn(params, cache, _make_batch(cfg, out[-1][:, None]), S + i)
        out.append(logits.argmax(-1))
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.stack(out, 1), {"prefill_s": t_prefill, "decode_s": t_decode,
                                 "decode_steps": gen - 1}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    if dev.type == "cuda":      # float32 products in float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = init_params(cfg, seed=args.seed, device=dev)
    B, S, G = args.batch, args.prompt_len, args.gen
    gen_rng = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen_rng, device=dev)
    tokens, stats = generate(cfg, params, prompts, G)
    tok_s = B * stats["decode_steps"] / max(stats["decode_s"], 1e-9)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} batch={B} prompt={S} gen={G} device={where}")
    print(f"prefill {stats['prefill_s'] * 1e3:.1f} ms; decode "
          f"{stats['decode_s'] * 1e3:.1f} ms ({tok_s:.1f} tok/s)")
    print("sample:", tokens[0, :12].tolist())
    return tokens


if __name__ == "__main__":
    main()
