"""The bounds on the waits of `jello_tpu_torch/cuda/collectives.py`, on the
CPU over gloo: a rank that outlives `run_ranks`' timeout fails the call
within that timeout plus a margin, with no rank left running and the
hung rank's Python stack on stderr; a group whose peer never joins
raises within `init_group`'s timeout.

The module imports nothing but torch and the collectives: a spawned rank
imports it to find its function."""

import datetime
import multiprocessing
import time

import pytest

from jello_tpu_torch.cuda import collectives

# The hung rank's run: its spawn and imports take a few seconds, and it
# prints its stacks 2 s before the deadline (a tenth of the timeout).
TIMEOUT = 20.0
# What the call may take past its timeout: stopping and joining the ranks.
MARGIN = 10.0


def _sleep_on_rank_1(g, seconds):
    """Rank 1 sleeps `seconds`; rank 0 returns at once."""
    if g.rank == 1:
        time.sleep(seconds)
    return g.rank


def test_torch_run_ranks_stops_a_hung_rank_within_its_timeout(capfd):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of 2 still running after 20.0 s"):
        collectives.run_ranks(_sleep_on_rank_1, 2, "gloo", "cpu", (600.0,), timeout=TIMEOUT)
    took = time.monotonic() - t0
    assert TIMEOUT <= took <= TIMEOUT + MARGIN, took
    assert not multiprocessing.active_children()
    err = capfd.readouterr().err
    print(err)
    assert "Timeout (" in err  # faulthandler's header
    assert "in _sleep_on_rank_1" in err and "test_torch_collectives.py" in err


def test_torch_group_rendezvous_is_bounded_by_its_timeout(tmp_path):
    """Rank 0 of two joins alone: the rendezvous raises after the group's
    timeout instead of waiting out gloo's 30 minutes."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        collectives.init_group(0, 2, "gloo", tmp_path / "store", "cpu",
                               datetime.timedelta(seconds=3))
    assert time.monotonic() - t0 <= 3 + MARGIN
