"""The system under test, driven through its public entry points.

Each entry holds the program's object built once in set-up and returns, per
call, the served answers; the harness times the calls. Nothing here reads
an answer inside the window beyond what the call returns.

* ``recognize_batch``: ``RecognizerEngine.recognize_batch(imgs, method,
  widths)`` over the pool's lines in calls of ``batch``;
* ``process_documents``: ``OCR.process_documents(pages)`` in calls of
  ``batch`` pages;
* ``extract_text``: ``OCR.extract_text(page)``, one page a call, with the
  call's stage times (``OCR.last_timer``).
"""
from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch


class Lines:
    def __init__(self, config: Dict, mix: Dict, root, device):
        from kiri_tpu_torch.engine import RecognizerEngine

        self.engine = RecognizerEngine.from_checkpoint(
            str(root / config["checkpoint"]), device=device)
        self.method = mix["method"]
        self.batch = int(mix["batch"])

    def program_config(self) -> Dict:
        return vars(self.engine.cfg)

    def plan(self, traffic: Dict) -> List[np.ndarray]:
        n = len(traffic["imgs"])
        return [np.arange(s, min(n, s + self.batch))
                for s in range(0, n, self.batch)]

    def call(self, traffic: Dict, idx: np.ndarray) -> Dict:
        before = self.engine.fallback_rows
        out = self.engine.recognize_batch(traffic["imgs"][idx], self.method,
                                          widths=traffic["widths"][idx])
        return {"answers": out, "fallback": self.engine.fallback_rows - before}

    def close(self) -> None:
        self.engine = None
        gc.collect()
        torch.cuda.empty_cache()


class Pages:
    def __init__(self, config: Dict, mix: Dict, root, device):
        from kiri_tpu_torch.pipeline import OCR

        self.ocr = OCR(model_path=str(root / config["checkpoint"]),
                       det_model_path=str(root / config["detector"]
                                          ["checkpoint"]),
                       det_method=config["detector"]["method"],
                       decode_method=mix["method"],
                       preprocess=config["detector"]["preprocess"],
                       device=device)
        self.entry = mix["entry"]
        self.batch = int(mix["batch"])

    def program_config(self) -> Dict:
        return vars(self.ocr.cfg)

    def plan(self, traffic: Dict) -> List[np.ndarray]:
        n = len(traffic["pages"])
        return [np.arange(s, min(n, s + self.batch))
                for s in range(0, n, self.batch)]

    def call(self, traffic: Dict, idx: np.ndarray) -> Dict:
        pages = [traffic["pages"][i] for i in idx]
        if self.entry == "process_documents":
            return {"answers": self.ocr.process_documents(pages)}
        _, rows = self.ocr.extract_text(pages[0])
        return {"answers": [rows],
                "stages": dict(self.ocr.last_timer.totals)}

    def close(self) -> None:
        from kiri_tpu_torch.pipeline import OCR

        self.ocr = None
        OCR._model_cache.clear()
        gc.collect()
        torch.cuda.empty_cache()


ENTRIES = {"recognize_batch": Lines, "process_documents": Pages,
           "extract_text": Pages}
