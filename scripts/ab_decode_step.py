#!/usr/bin/env python3
"""Decode ms/step of the PyTorch port's serving engine in one checkout:
chip_smoke.py's phase 3b (``decode_phase``: 8 slots x 256 greedy tokens
through the captured decode graph, its full sampler variant where the
checkout has one, and the eager loop) at Llama-3.1-8B shape with random
bf16 weights, paged bf16 KV then paged int8 KV. It builds that
checkout's kernels and prints one line, ``AB <tag> {config: {way:
ms/step}} <card name, power limit>``.

To compare two commits on one card, unpack the other one with
``git archive`` into the git-ignored ``build/`` and run both sides in one
call, alternating (parent, change, change, parent), one process each:

    for side in parent change change parent; do
      python3 scripts/ab_decode_step.py $([ $side = parent ] && echo build/parent || echo .) $side
    done
"""

from __future__ import annotations

import gc
import json
import os
import sys


def main(root: str, tag: str):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import torch

    from localai_tpu_torch.backend.runner import load_model

    card = cs.setup()
    model_dir = os.path.join(root, "build", "chip_smoke", "llama-3.1-8b")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cs.LLAMA31_8B, f)
    knobs = {c: k for c, k, _m, _n in cs.CONFIGS}
    out = {}
    for config in ("paged", "int8"):
        lm = load_model(model_dir, "llama-3.1-8b", num_slots=cs.S_SLOTS,
                        context_size=cs.C_MAX, dtype="bfloat16",
                        random_weights=cs.SEED, device="cuda", prefill_chunk=512,
                        kv_page_size=cs.PG, decode_burst=16, **knobs[config])
        try:
            r = cs.decode_phase(lm, card, config)
        finally:
            lm.engine.shutdown()
            del lm
            gc.collect()
            torch.cuda.empty_cache()
        out[config] = {w: r[w]["ms_per_step"] for w in ("graph", "full", "eager")
                       if w in r}
    print("AB", tag, json.dumps(out), card, flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
