"""The one generator of the benchmark's traffic: it reads a mix's parameters
(``traffic/mixes/<name>.json``) and makes the inputs from the seed.

* ``"lines"``: a pool of line images at the model's input size, drawn as
  the old ``bench.py`` drew them (``synth.DatasetGenerator`` without
  augmentation, Khmer text from ``sample_khmer_text`` and English from
  ``sample_text`` over the vocabulary's characters), resized to the model's
  height with ``resize_keep_ratio_pad_np`` and measured with
  ``content_width``. Lines are drawn until every (script, width bucket)
  quota of the mix is full; lines past a full quota are dropped. So every
  seed gives the same number of lines of each script in each bucket, in a
  seeded order, and only the texts and glyphs change with the seed.
* ``"lines"`` with ``"sizes"``: the mix fixes every call's lines as
  [script, width bucket, characters] (``size_plan`` deals them from the
  pool that ``"quota"`` gives with the mix's ``"sizes_seed"``). For each
  the seed draws a text of that many characters and renders it until it
  lands in its bucket, then shuffles the lines within each call. So every
  seed gives each call the same sizes, and with them the same decoding
  work, in another order; only the texts and glyphs change.
* ``"pages"``: a pool of pages from ``docsynth.DocumentGenerator`` with
  augmentation, one document generator per page seeded from the seed. Each
  page's (width, height, layout) comes from the mix's fixed lists, in an
  order the seed shuffles.

Everything is drawn on the host from ``random.Random(seed)`` and
``numpy.random.default_rng``; a seed is any non-negative integer.
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List

import numpy as np

from .docsynth import DOC_FONT_SIZES, DocumentGenerator
from .preprocess import content_width, resize_keep_ratio_pad_np, width_bucket
from .synth import (DatasetGenerator, FontManager, sample_khmer_text,
                    sample_text)

MIXES = Path(__file__).resolve().parent / "mixes"
#: Texts drawn for one line of a fixed size before the draw gives up.
TEXT_TRIES = 100_000


def load_mix(name: str) -> Dict:
    return json.loads((MIXES / f"{name}.json").read_text())


def _charset(vocab_path) -> str:
    vocab = json.loads(Path(vocab_path).read_text(encoding="utf-8"))
    return "".join(t for t in vocab if len(t) == 1)


def lines(mix: Dict, seed: int, cfg: Dict, vocab_path) -> Dict:
    """{"imgs": u8 [N, IMG_H, IMG_W], "widths": int32 [N], "texts": [N]}."""
    h, w = int(cfg["IMG_H"]), int(cfg["IMG_W"])
    gen = DatasetGenerator(height=h, augment=bool(mix["augment"]), seed=seed)
    charset = _charset(vocab_path)
    quota = {(script, int(b)): int(n)
             for script, per in mix["quota"].items() for b, n in per.items()}
    left = dict(quota)
    kw, ew = mix["khmer_words"], mix["english_words"]
    imgs, widths, texts, scripts = [], [], [], []
    tries = 0
    while any(left.values()):
        tries += 1
        if tries > mix["max_draws"]:
            raise RuntimeError(f"the quotas {left} were not filled in "
                               f"{mix['max_draws']} draws")
        script = ("khmer" if left_of(left, "khmer")
                  and (not left_of(left, "english")
                       or gen.rng.random() < mix["khmer_share"])
                  else "english")
        text = (sample_khmer_text(gen.rng, kw[0], kw[1]) if script == "khmer"
                else sample_text(gen.rng, ew[0], ew[1], charset))
        samples = gen.generate_samples([text])
        if not samples:
            continue
        img = samples[0]["image"]
        cw = content_width(img.shape, h, w)
        key = (script, width_bucket(cfg, cw))
        if left.get(key, 0) <= 0:
            continue
        left[key] -= 1
        imgs.append(resize_keep_ratio_pad_np(img, h, w))
        widths.append(cw)
        texts.append(text)
        scripts.append(script)
    order = np.random.default_rng(seed).permutation(len(imgs))
    return {"imgs": np.stack(imgs)[order],
            "widths": np.asarray(widths, np.int32)[order],
            "texts": [texts[i] for i in order],
            "scripts": [scripts[i] for i in order], "draws": tries}


def size_plan(pool: Dict, cfg: Dict, batch: int) -> List[List]:
    """The pool's lines as calls of ``batch``, each line [script, width
    bucket, characters]: the lines of each bucket, longest first, are dealt
    to the calls back and forth, so that every call holds about the same
    sizes."""
    n_calls = len(pool["texts"]) // batch
    per: Dict[int, List] = {}
    for s, w, t in zip(pool["scripts"], pool["widths"], pool["texts"]):
        per.setdefault(width_bucket(cfg, int(w)), []).append([s, len(t)])
    calls: List[List] = [[] for _ in range(n_calls)]
    turn = 0
    for bucket, lines_ in sorted(per.items()):
        for script, n in sorted(lines_, key=lambda x: (-x[1], x[0])):
            k = turn % (2 * n_calls)
            calls[k if k < n_calls else 2 * n_calls - 1 - k].append(
                [script, bucket, n])
            turn += 1
    return calls


def _text(rng: random.Random, mix: Dict, charset: str, script: str,
          n: int) -> str:
    """A text of ``n`` characters drawn as ``lines`` draws one."""
    kw, ew = mix["khmer_words"], mix["english_words"]
    for _ in range(TEXT_TRIES):
        text = (sample_khmer_text(rng, kw[0], kw[1]) if script == "khmer"
                else sample_text(rng, ew[0], ew[1], charset))
        if len(text) == n:
            return text
    raise RuntimeError(f"no {script} text of {n} characters in "
                       f"{TEXT_TRIES} draws")


def sized_lines(mix: Dict, seed: int, cfg: Dict, vocab_path) -> Dict:
    """As ``lines``, to the mix's fixed ``sizes``, call by call."""
    h, w = int(cfg["IMG_H"]), int(cfg["IMG_W"])
    gen = DatasetGenerator(height=h, augment=bool(mix["augment"]), seed=seed)
    order = np.random.default_rng(seed)
    charset = _charset(vocab_path)
    imgs, widths, texts, scripts = [], [], [], []
    tries = 0
    for call in mix["sizes"]:
        if len(call) != int(mix["batch"]):
            raise ValueError(f"a call of {len(call)} lines in a mix of "
                             f"calls of {mix['batch']}")
        drawn = []
        for script, bucket, n in call:
            while True:
                tries += 1
                if tries > mix["max_draws"]:
                    raise RuntimeError(f"the sizes were not drawn in "
                                       f"{mix['max_draws']} draws")
                text = _text(gen.rng, mix, charset, script, int(n))
                samples = gen.generate_samples([text])
                if not samples:
                    continue
                img = samples[0]["image"]
                cw = content_width(img.shape, h, w)
                if width_bucket(cfg, cw) == int(bucket):
                    break
            drawn.append((resize_keep_ratio_pad_np(img, h, w), cw, text,
                          script))
        for i in order.permutation(len(drawn)):
            img, cw, text, script = drawn[i]
            imgs.append(img)
            widths.append(cw)
            texts.append(text)
            scripts.append(script)
    return {"imgs": np.stack(imgs), "widths": np.asarray(widths, np.int32),
            "texts": texts, "scripts": scripts, "draws": tries}


def left_of(left: Dict, script: str) -> bool:
    return any(n > 0 for (s, _), n in left.items() if s == script)


def pages(mix: Dict, seed: int) -> Dict:
    """{"pages": [u8 [H, W]], "sizes": [(w, h)], "layouts": [str]}."""
    rng = random.Random(seed)
    plan = [(int(s[0]), int(s[1]), lay)
            for s, lay in zip(mix["sizes"], mix["layouts"])]
    rng.shuffle(plan)
    fonts = FontManager(sizes=DOC_FONT_SIZES)
    out: Dict[str, List] = {"pages": [], "sizes": [], "layouts": []}
    for pw, ph, layout in plan:
        doc = DocumentGenerator(pw, ph, fonts=fonts, seed=rng.getrandbits(63),
                                augment=bool(mix["augment"]),
                                khmer_ratio=float(mix["khmer_share"]))
        out["pages"].append(doc.generate(layout)["image"])
        out["sizes"].append((pw, ph))
        out["layouts"].append(layout)
    return out


def make(mix: Dict, seed: int, cfg: Dict, vocab_path) -> Dict:
    if mix["inputs"] == "lines":
        if "sizes" in mix:
            return sized_lines(mix, seed, cfg, vocab_path)
        return lines(mix, seed, cfg, vocab_path)
    if mix["inputs"] == "pages":
        return pages(mix, seed)
    raise ValueError(f"unknown inputs {mix['inputs']!r}")
