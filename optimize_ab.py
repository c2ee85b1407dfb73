#!/usr/bin/env python3
"""The online optimize's time on one CUDA card, for an A/B of two
checkouts of the repository.

    python3 optimize_ab.py <checkout>

runs `bnv_fusion_tpu_torch.run_e2e` from <checkout> at that checkout's
chip_smoke.py e2e point (bench.py's operating point, 64 optimize steps,
seeded weights), then three more `NeuralMap.optimize(64)` calls on the
same map, each timed on the host clock around a device synchronise, and
prints one line:

    AB <checkout name> e2e <s/iter of run_e2e's optimize> extra <s/iter> x3

Alternate the checkouts in one call to the card (parent, change, change,
parent, ...): the optimize is paced by the host, whose load drifts over a
call.  Needs CUDA.
"""

import os
import sys
import tempfile
import time


def main(root: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("optimize_ab: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from bnv_fusion_tpu_torch import run_e2e
    from bnv_fusion_tpu_torch.nn import init_model

    with tempfile.TemporaryDirectory() as tmp:
        out = run_e2e.run(chip_smoke.E2E_OVERRIDES + [f"output_dir={tmp}"],
                          params=init_model(0))
        nm = out["nmap"]
        e2e = nm.timer.times["global"] / out["global_steps"]
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            nm.optimize(64)
            torch.cuda.synchronize()
            ts.append((time.time() - t0) / 64)
    print(f"AB {os.path.basename(root)} e2e {e2e:.4f} extra "
          + " ".join(f"{t:.4f}" for t in ts), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
