"""Fail-point injection for crash-recovery testing (the port's copy of
tendermint_tpu/libs/fail.py).

Counterpart of the reference's `libs/fail`
(reference: libs/fail/fail.go:27): a process-wide counter of fail points;
when the environment variable ``FAIL_TEST_INDEX`` equals the current call
index the process exits hard, letting the persistence test rig
(reference: test/persist/test_failure_indices.sh) assert WAL/handshake
recovery at every crash site.
"""

from __future__ import annotations

import os
import sys

_call_index = -1
_label_counts: dict = {}


def reset() -> None:
    global _call_index
    _call_index = -1
    _label_counts.clear()


def fail() -> None:
    global _call_index
    env = os.environ.get("FAIL_TEST_INDEX")
    if env is None:
        return
    _call_index += 1
    if _call_index == int(env):
        sys.stderr.write(f"*** fail-point {_call_index} tripped — exiting\n")
        sys.stderr.flush()
        os._exit(1)


def fail_point(label: str = "") -> None:
    """Named fail point; call order defines the ``FAIL_TEST_INDEX`` index
    (as in the reference).  ``FAIL_TEST_LABEL="<label>:<n>"`` additionally
    exits hard at the n-th execution (1-based; default 1) of that SPECIFIC
    site, so a rig can pin a crash to one spot — e.g. between the WAL
    ENDHEIGHT marker and the pipelined ABCI delivery landing — regardless
    of how many unrelated fail points run first."""
    env = os.environ.get("FAIL_TEST_LABEL")
    if env and label:
        want, _, nth = env.partition(":")
        if label == want:
            _label_counts[label] = _label_counts.get(label, 0) + 1
            if _label_counts[label] == int(nth or 1):
                sys.stderr.write(
                    f"*** fail-point {label!r} #{_label_counts[label]} tripped — exiting\n"
                )
                sys.stderr.flush()
                os._exit(1)
    fail()
