"""Serve a small model with batched requests (the paper's κ-batching for LMs),
on the PyTorch port.

    PYTHONPATH=src python examples_torch/serve_lm.py                # on the GPU
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu   # plain PyTorch

Counterpart of ``examples/serve_lm.py``: the same smoke mixtral in float32
and the same 10 requests; the weights are drawn from
``torch.Generator(device).manual_seed(0)``.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain PyTorch versions)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = dataclasses.replace(smoke_config(get_config("mixtral-8x7b")),
                              compute_dtype="float32")
    api = build_model(cfg, device=dev, remat=False)
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    engine = ServingEngine(api, params, batch_size=4, max_len=64)

    rng = np.random.default_rng(0)
    requests = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                max_new_tokens=6)
        for i in range(10)
    ]
    t0 = time.time()
    results = engine.serve(requests)
    dt = time.time() - t0
    n_tok = sum(len(v) for v in results.values())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "1 CPU"
    print(f"MoE serving: {len(requests)} requests → {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s on {where})")
    for uid in sorted(results)[:3]:
        print(f"  request {uid}: tokens {results[uid]}")


if __name__ == "__main__":
    main()
