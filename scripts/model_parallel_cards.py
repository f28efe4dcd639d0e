#!/usr/bin/env python3
"""Run the port's model-parallel paths over NCCL across the 4 cards of one
host, one rank a card, each path against the unsharded port on card 0:

    python3 scripts/model_parallel_cards.py

It builds the kernels, runs `cli/sequence.py --synthetic --n_frames 24 --ba`
for the solvers' problem (`chip_smoke.run_sequence_cli`), then
`chip_smoke.run_model_parallel_cards`: context-parallel SuperGlue over 4
ranks, pipelined SuperGlue at data 2 x pipe 2, a tensor-parallel training
step at model 4 and the sharded pose graph and bundle adjustment over 4
ranks, each rank's wall ms and kernel launches a call, and their agreement
with the unsharded port. `chip_smoke.py` itself needs one card and runs
these paths in a world of one NCCL rank and of 4 gloo ranks on that card.
Exits non-zero without 4 CUDA cards.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if torch.cuda.device_count() < 4:
        print(f"model_parallel_cards: needs 4 CUDA cards, have {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from image_matching_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi().replace("\n", "; ")
    print(f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    captured = chip_smoke.run_sequence_cli(torch, torch.device("cuda", 0), smi)
    chip_smoke.run_model_parallel_cards(torch, smi, captured)
    return 0


if __name__ == "__main__":
    sys.exit(main())
