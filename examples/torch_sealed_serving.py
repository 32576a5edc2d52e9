"""Sealed serving on the PyTorch port: batched requests against
ciphertext-resident weights, the paper's edge-inference scenario, as
``examples/sealed_serving.py`` runs it, through ``repro_torch`` only.
SEAL-encrypted weights produce the plaintext model's generations while
the stored image is ciphertext, under each of the four memory-encryption
modes.

Run: PYTHONPATH=src python examples/torch_sealed_serving.py [--device cpu]
(the card by default).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.config import SealConfig
from repro_torch.configs import get_reduced
from repro_torch.core.sealed_store import sealed_byte_report
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced("granite_3_2b").with_(dtype="float32")
    params = T.init_params(cfg, 0, dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=12) for _ in range(6)]

    results = {}
    for mode in ["none", "direct", "counter", "coloe"]:
        seal = None if mode == "none" else SealConfig(mode=mode,
                                                      smart_ratio=0.5)
        eng = ServeEngine(cfg, params, batch_slots=3, max_len=48, seal=seal,
                          device=dev)
        for p in prompts:
            eng.submit(p, max_tokens=8)
        t0 = time.time()
        done = eng.run()
        dt = time.time() - t0
        outs = tuple(tuple(r.out) for r in sorted(done, key=lambda r: r.rid))
        results[mode] = outs
        extra = ""
        if eng.sealed is not None:
            rep = sealed_byte_report(eng.sealed)
            extra = (f" enc_frac={rep['enc_fraction']:.2f}"
                     f" storage_overhead={rep['overhead']*100:.2f}%")
        print(f"{mode:8s}: {len(done)} reqs in {dt:5.2f}s "
              f"({eng.stats['tokens']/dt:6.1f} tok/s){extra}")

    same = all(results[m] == results["none"] for m in results)
    print(f"\nall modes produce identical generations: {same}")
    print("first request tokens:", list(results["none"][0])[:8])
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
