"""tools/slab_split.py's variant forms of T3, checked on the CPU.

The tool builds each form by textual edits of csrc/refine.cu, and each edit
must match the source as many times as it states; these tests apply every
form to the source as it stands, so that a change of the kernel that leaves
the tool's edits behind fails here rather than on the card. No form may
touch K3 or the C signature the tool binds; the counters form alone adds a
reader.
"""

from __future__ import annotations

import pytest

from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.tools import slab_split

SRC = (cuda.CSRC / cuda.SOURCES["refine"]).read_text()
T3 = "// ---- T3: K3's body over pre-gathered slabs"
ENTRY = 'extern "C" int omni_refine_slab('
ERROR = 'extern "C" const char* omni_cuda_error_string('


@pytest.mark.parametrize("form", list(slab_split.EDITS))
def test_form_applies_to_the_source(form):
    out = slab_split.variant_source(SRC, form)
    assert (out == SRC) == (form == "committed")
    assert out[:out.index(T3)] == SRC[:SRC.index(T3)]  # K3 and everything before T3

    def signature(text):
        start = text.index(ENTRY)
        return text[start:text.index("{", start)]

    assert signature(out) == signature(SRC)
    assert out[out.index(ERROR):] == SRC[SRC.index(ERROR):]
    assert ('extern "C" int omni_slab_counters(' in out) == (form == "counters")


def test_a_stale_edit_is_refused():
    with pytest.raises(ValueError, match="found 0 times"):
        slab_split.variant_source("// no kernel here\n", "producers_2")


def test_the_forms_hold_alternatives_diagnostics_and_the_counters():
    assert slab_split.EDITS["committed"] == (True, [])
    assert {f for f, (computes, _) in slab_split.EDITS.items() if not computes} == {
        "no_products", "no_keyword", "no_planes"}
    assert slab_split.EDITS["counters"][0]
    assert slab_split.SHAPES == {"tool": (1536, 128), "select": (448, 64), "qg4": (448, 512)}
