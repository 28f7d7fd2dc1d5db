"""tools/gather_split.py's variant forms of K2 and K3, checked on the CPU.

The tool builds each form by textual edits of csrc/dd_rows.cu and
csrc/refine.cu, and each edit must match the source as many times as it
states; these tests apply every form to the sources as they stand, so that
a change of a kernel that leaves the tool's edits behind fails here rather
than on the card. No form may touch the C interface the tool binds.
"""

from __future__ import annotations

import pytest

from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.tools import gather_split

FORMS = [(source, form) for source, forms in gather_split.EDITS.items() for form in forms]
ENTRY = {"dd_rows": 'extern "C" int omni_dd_rows(', "refine": 'extern "C" int omni_refine('}


@pytest.mark.parametrize("source,form", FORMS)
def test_form_applies_to_the_source(source, form):
    src = (cuda.CSRC / cuda.SOURCES[source]).read_text()
    out = gather_split.variant_source(src, source, form)
    assert (out == src) == (form == "committed")
    entry = src.index(ENTRY[source])
    assert out[out.index(ENTRY[source]):] == src[entry:]  # the interface and what follows


def test_a_stale_edit_is_refused():
    with pytest.raises(ValueError, match="found 0 times"):
        gather_split.variant_source("// no kernel here\n", "refine", "division")


def test_every_source_has_its_committed_form_and_a_diagnostic():
    for forms in gather_split.EDITS.values():
        assert forms["committed"] == (True, [])
        assert any(not computes for computes, _ in forms.values())
