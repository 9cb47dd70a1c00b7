#!/usr/bin/env python3
"""Run one checkout's build and training-speed phases on one card.

    python3 probes/train_pair.py TREE

TREE is the root of a checkout; its ``chip_smoke.py`` (and so its ``src``)
is imported, so two commits are compared by running this script once per
tree within one call, in the order A, B, B, A. It runs that checkout's
phase 2 (build every kernel), phase 29 (``launch.train`` on internvl2-1b
at full width: ms per step, tokens/s, launches, a restart) and phase 30
(the three remat modes' ms per step, busy share and peak memory, then the
flash and FFN backward against the kernels' forward at the step's shapes),
then the card's name and power limit. It fails as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(argv[0]).resolve()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("train_pair: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    cs.say(f"[pair] tree {tree}: repro_torch from "
           f"{Path(repro_torch.__file__).resolve().parent}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.phase_build()
    cs.phase_train_entry(device)
    cs.phase_train_remat(device)
    cs.say(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
