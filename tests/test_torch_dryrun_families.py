"""PyTorch port, the dry run on the fake 16 x 16 pod for the two families
that ``test_torch_dryrun.py`` leaves out (kept apart so that each file
runs in about a minute): the hybrid (hymba-1.5b) and the encoder-decoder
(seamless-m4t-medium), smoke configs, for train_4k, prefill_32k and
decode_32k.  Each record is ``"ok"`` with the reference's keys, and rank
0's argument bytes equal the reference's for the same specs (see
``test_torch_dryrun.py`` for how uneven splits are padded).
"""
import pytest

from repro_torch.launch import dryrun
from test_torch_dryrun import (KINDS, check_record, reference_args_bytes,
                               smoke_overrides)

FAMILIES = {"hybrid": "hymba-1.5b", "audio": "seamless-m4t-medium"}


@pytest.mark.parametrize("shape", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_smoke_cells_run_on_the_fake_pod(family, shape):
    arch = FAMILIES[family]
    rec = dryrun.run_cell(arch, shape, False,
                          cfg_overrides=smoke_overrides(arch))
    check_record(rec, arch, shape)
    assert rec["memory"]["args_gb"] * 1e9 == pytest.approx(
        reference_args_bytes(arch, shape, smoke=True), rel=1e-12)
    if shape == "prefill_32k":
        # the decoder's (and hymba's) attention through the flash kernel
        assert rec["kernels"]["flash_attention_bhsd"]["calls"] == 2
