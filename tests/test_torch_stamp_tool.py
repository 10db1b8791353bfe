"""``tools/stamp_kernels.py`` on the CPU: every probe finds an anchor set that
fits this tree's kernel source, each of its anchors exactly once, so a change
to a kernel that moves an anchor shows here and not first on the card.  The
stamped builds run on a card only (``python3 tools/stamp_kernels.py KERNEL``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import stamp_kernels  # noqa: E402


@pytest.mark.parametrize("name", sorted(stamp_kernels.PROBES))
def test_probe_anchors_fit_this_tree(name):
    probe = stamp_kernels.PROBES[name]
    with open(os.path.join(ROOT, "pgmpy_tpu_torch", "csrc", probe.source)) as fh:
        text = fh.read()
    sets = stamp_kernels.EDITS[probe.edits]
    fitting = [edits for edits in sets if all(text.count(old) == 1 for old, _ in edits)]
    assert fitting, f"no anchor set of {name} fits {probe.source}"
    stamped = stamp_kernels.instrument(text, probe.source, probe.edits)
    assert "clock64()" in stamped and stamped.count("stamp_") > text.count("stamp_")
    for old, new in fitting[0]:
        assert new in stamped
