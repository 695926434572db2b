"""The dry-run's train step on placeholder ranks (``lower_cell`` with the
train kind; the forward, remat's recompute, the backward and AdamW over
DTensors on meta): reduced configs on the 512-rank (2, 16, 16) mesh and
the 256-rank one, with the checks of ``test_torch_dryrun.py``."""
from __future__ import annotations

import pytest

from test_torch_dryrun import placeholder_ranks, run_cell  # noqa: F401


@pytest.mark.parametrize("multi", [True, False], ids=["2x16x16", "16x16"])
@pytest.mark.parametrize("aid", ["yi_6b", "rwkv6_7b"])
def test_reduced_train_step_runs_on_placeholder_ranks(aid, multi):
    run_cell(aid, "train", multi)
