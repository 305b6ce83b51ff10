"""Serving example on the PyTorch port: batched autoregressive decoding
with ring KV caches.

``examples/serve_decode.py`` on ``repro_torch``, on the card unless
``--device`` names another.  Prefills a batch of prompts on a reduced
fp32 model of ``--arch`` (``attn_impl="chunked"``, as the JAX example
runs), then decodes greedily with the ring-buffer cache, reporting
per-step latency.

For a config with a vision frontend (internvl2-26b) the patches take
positions 0 .. F - 1 ahead of the prompt, so step i decodes at ``pos =
F + prompt_len + i`` and the cache holds F more rows.  This follows the
JAX package's own test (``tests/test_smoke_archs.py:76``), not
``serve_decode.py``, which decodes at ``prompt_len + i``.  An encoder's
frames (seamless-m4t-large-v2) take no decoder positions.

Without ``params`` the weights come from the port's own seeded init
(``model.init(0)``), not the JAX package's PRNG draw, so the sampled
tokens differ from ``serve_decode.py``'s by the draw; tests pass the
JAX draw as ``params`` (a numpy tree in the JAX layout).

  PYTHONPATH=src python examples/serve_decode_torch.py [--arch llama3.2-3b] [--steps 32] [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.synthetic import TokenTaskStream
from repro_torch.device import resolve_device
from repro_torch.models import ModelOptions, build_model


def main(argv=None, *, params=None):
    """-> {"prefill_logits" (B, 1, V), "tokens" (B, 1 + steps), "lat_ms"
    (the steps after the first)} on the host."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless named (e.g. cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    cfg = ARCHS[args.arch].reduced(dtype="float32")
    # a decoder-only frontend's patches sit ahead of the prompt
    offset = (cfg.frontend_tokens
              if cfg.frontend and not cfg.encoder_layers else 0)
    total = offset + args.prompt_len + args.steps
    model = build_model(cfg, ModelOptions(
        attn_impl="chunked", moe_impl="dense", block_kv=32, remat=False,
        prefill_cache_capacity=total + 8,
    ))
    params = (model.init(0, device=device) if params is None
              else lm_params_from_jax(params, device=device))

    stream = TokenTaskStream(cfg.vocab_size, args.prompt_len, seed=1)
    prompts = torch.from_numpy(
        stream.batch(args.batch)["tokens"].astype(np.int32)).to(device)
    batch = {"tokens": prompts}
    if cfg.frontend:
        batch["frontend"] = torch.zeros(
            (args.batch, cfg.frontend_tokens, cfg.d_model),
            dtype=torch.float32, device=device)

    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, batch)
        sync()
        print(f"prefill {args.batch}x{args.prompt_len}: "
              f"{(time.perf_counter()-t0)*1e3:.1f} ms")
        prefill_logits = logits.cpu()

        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        generated = [tok]
        lat = []
        for i in range(args.steps):
            pos = offset + args.prompt_len + i
            t0 = time.perf_counter()
            logits, caches = model.decode_step(params, tok, caches, pos)
            sync()
            lat.append(time.perf_counter() - t0)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            generated.append(tok)
    out = torch.cat(generated, dim=1).cpu().numpy()
    lat = np.asarray(lat[1:]) * 1e3  # skip the first step, as serve_decode.py
    print(f"decoded {args.steps} tokens/seq; per-step "
          f"p50={np.percentile(lat,50):.2f}ms p99={np.percentile(lat,99):.2f}ms")
    # the synthetic task is affine-recurrent: a well-trained model would
    # continue it; untrained output is random — we just show the plumbing
    print("sample continuation:", out[0, :12])
    print("serve_decode OK")
    return {"prefill_logits": prefill_logits, "tokens": out, "lat_ms": lat}


if __name__ == "__main__":
    main()
