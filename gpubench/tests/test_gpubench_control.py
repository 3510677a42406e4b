"""The control on the card: the reference one precision step below the
configuration, in the program's place, fails the check that the program's
own answers pass (float8 operands in the recognizer, TF32 in DB). At a
size a test run holds; ``gpubench/control.py`` reads the same at the cells'
own sizes. Skips without a card."""
import pytest

from control import control_answers
from harness import spec
from harness.cell import model_cfg
from harness.entries import ENTRIES
from reference import check
from traffic import make

SIZES = {"lines-fast": {"quota": {"english": {"160": 8, "320": 24,
                                              "480": 24, "640": 16},
                                  "khmer": {"320": 32, "480": 24}},
                        "check_lines": 128},
         "lines-accurate": {"sizes": spec.load_cell("lines-accurate")
                            ["mix"]["sizes"][:1], "check_lines": 128},
         "page-interactive": {"sizes": [[960, 1280], [1280, 960]],
                              "layouts": ["dense", "two_column"],
                              "check_pages": 2}}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("seed", [2 ** 31 + 301, 2 ** 31 + 302,
                                  2 ** 31 + 303])
def test_control_fails_where_the_program_passes(card, name, seed):
    cell = spec.load_cell(name)
    cell = dict(cell, mix=dict(cell["mix"], **SIZES[name]))
    cfg, mix = model_cfg(cell), cell["mix"]
    entry = ENTRIES[mix["entry"]](cell["config"], mix, cell["root"], card)
    traffic = make.make(mix, seed, cfg, cell["root"] / cell["config"]["vocab"])
    served = {}
    for idx in entry.plan(traffic):
        for i, a in zip(idx, entry.call(traffic, idx)["answers"]):
            served[int(i)] = a
    program_cfg = entry.program_config()
    entry.close()
    ours = check.run(cell, cfg, program_cfg, traffic, served, seed, card)
    assert ours["correct"], ours["numbers"]
    n = mix["check_lines" if mix["inputs"] == "lines" else "check_pages"]
    keys = check.sample(served, int(n), seed)
    low = control_answers(cell, cfg, traffic, served, keys, card)
    theirs = check.run(cell, cfg, program_cfg, traffic, low, seed, card)
    assert not theirs["correct"], theirs["numbers"]
