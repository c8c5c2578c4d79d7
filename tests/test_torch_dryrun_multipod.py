"""Dry-run records on the 2x16x16 production mesh (a fake group of 512
ranks, in a subprocess): reduced dense, ssm, hybrid and moe configs at
train, prefill and decode, checked as ``test_torch_dryrun.py`` checks the
16x16 mesh's (a file of its own: its cells take ~1 min on the CPU)."""
import pytest

from test_torch_dryrun import ARCHS, CELL_SHAPES, check_record, family_cells, run_cells


@pytest.fixture(scope="module")
def records():
    return run_cells("2x16x16", family_cells())


@pytest.mark.parametrize("shape", CELL_SHAPES)
@pytest.mark.parametrize("family", list(ARCHS))
def test_dry_run_record_multipod(records, family, shape):
    check_record(records[f"{ARCHS[family]}/{shape}/tp/True"], family, shape, "2x16x16")


def test_multipod_tokens_split_over_the_pods(records):
    """Each rank of 512 holds 256 x 4,096 / 32 tokens of the dense train
    cell's batch (pod x data): its argument bytes hold the batch's share
    (tokens and labels, int64)."""
    rec = records[f"{ARCHS['dense']}/train_4k/tp/True"]
    assert rec["scan_trip_counts"][0] == {"loop": "layers", "trips": 2}
    assert rec["memory"]["argument_size_in_bytes"] > 2 * 8 * 256 * 4096 // 32
