"""Shared pieces of the port's tests (imports torch and pytest, never jax, so
the card-only tests and chip_smoke.py can use it too)."""

import pytest
import torch

# the reference's three Smith-Waterman scoring profiles (tests/test_ssw.py)
# and one with gap_open < gap_extend, where the lazy F differs from the
# textbook F over H
SCORINGS_ALL = [
    dict(match=2, mismatch=2, gap_open=3, gap_extend=1, ambiguity=2),
    dict(match=1, mismatch=1, gap_open=1, gap_extend=1, ambiguity=1),
    dict(match=2, mismatch=4, gap_open=4, gap_extend=2, ambiguity=1),
    dict(match=2, mismatch=3, gap_open=1, gap_extend=3, ambiguity=1),
]
# a mismatch score past a signed byte: the CUDA kernel's compare-and-select
# substitution (it permutes score bytes when match, -mismatch and -ambiguity
# all fit one)
SCORING_WIDE = dict(match=2, mismatch=200, gap_open=3, gap_extend=1, ambiguity=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run long loops of small torch ops: one intra-op
    thread keeps them fast when several test processes share the cores.
    Imported into a test module, it applies to that module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
