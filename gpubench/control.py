"""The readings that the check's limits are set from, in one process.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13 \
                                [--control-seeds 3]

For each seed: the pool made from the seed; the program serves it once at
the cell's own load (every call of a window's pass, after a warm-up pass)
and the check judges its answers (the lower readings); then the control,
the plain reference in the program's place one precision step below the
configuration, answers the same sampled inputs and the same check judges
those (the upper readings):

* lines: the reference recognizer with every convolution and matrix
  product on float8 e4m3 operands decodes the lines (greedy CTC, or the
  accurate rule);
* pages: the configuration's reference detector one step down
  (``reference/detectors/<method>.py`` with ``control=True``; DB: its net
  with TF32 on, boxes by ``reference/boxes.py``) draws the boxes and their
  scores, and the float8 recognizer reads their crops.

Prints one JSON line per seed and side. Runs on the card only; the
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def control_answers(cell, cfg, traffic, served, keys, device):
    """The control's answers for the sampled inputs ``keys``."""
    from pathlib import Path

    from reference import detectors
    from reference.boxes import crop_lines
    from reference.check import ENGINE_METHOD
    from reference.judge import read_lines
    from reference.recognizer import RefRecognizer
    from reference.tokens import Vocab

    root = Path(cell["root"])
    config, mix = cell["config"], cell["mix"]
    method = ENGINE_METHOD[mix["method"]]
    vocab = Vocab(root / config["vocab"], bool(cfg["KHMER_VISUAL_ORDER"]))
    low = RefRecognizer(root / config["checkpoint"], cfg, device, "fp8")

    def read(imgs, widths):
        return read_lines(low, vocab, cfg, method, imgs, widths)[0]

    if mix["inputs"] == "lines":
        texts = read(traffic["imgs"][keys], traffic["widths"][keys])
        return {k: (t, 0.0) for k, t in zip(keys, texts)}
    det = config["detector"]
    detector = detectors.load(det, root, device, control=True)
    out = {}
    for k in keys:
        page = traffic["pages"][k]
        boxes = detector.boxes(page)
        lines, widths, kept = crop_lines(cfg, page, [b["box"] for b in boxes],
                                         det["crop_padding"])
        out[k] = [{"box": list(boxes[j]["box"]), "text": t,
                   "det_confidence": boxes[j]["score"]}
                  for j, t in zip(kept, read(lines, widths))]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first n seeds only")
    args = ap.parse_args(argv)

    import torch

    from harness import spec
    from harness.cell import model_cfg
    from harness.entries import ENTRIES
    from reference import check
    from traffic import make

    if not torch.cuda.is_available():
        print("gpubench: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    cfg = model_cfg(cell)
    mix = cell["mix"]
    entry = ENTRIES[mix["entry"]](cell["config"], mix, cell["root"], "cuda")
    program_cfg = entry.program_config()
    for n_seed, seed in enumerate(int(s) for s in args.seeds.split(",")):
        traffic = make.make(mix, seed, cfg,
                            cell["root"] / cell["config"]["vocab"])
        plan = entry.plan(traffic)
        served = {}
        for _ in range(2):                  # a warm-up pass, then the pass
            for idx in plan:                # that is judged
                for i, a in zip(idx, entry.call(traffic, idx)["answers"]):
                    served[int(i)] = a
        res = check.run(cell, cfg, program_cfg, traffic, served, seed, "cuda")
        print(json.dumps({"seed": seed, "side": "program",
                          "readings": res["readings"]}), flush=True)
        if args.control_seeds is not None and n_seed >= args.control_seeds:
            continue
        n = mix["check_lines" if mix["inputs"] == "lines" else "check_pages"]
        keys = check.sample(served, int(n), seed)
        low = control_answers(cell, cfg, traffic, served, keys, "cuda")
        res = check.run(cell, cfg, program_cfg, traffic, low, seed, "cuda")
        print(json.dumps({"seed": seed, "side": "control",
                          "readings": res["readings"]}), flush=True)
    entry.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
