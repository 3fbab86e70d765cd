"""The production ssm and hybrid train records of the port's dry run
(ROADMAP A 7.4): rwkv6-3b and zamba2-1.2b at ``train_4k`` on the 16 x 16
and the 2 x 16 x 16 mesh, the four combinations that ``dryrun --all``
could not count before the SSM loops folded under autograd.  Apart from
``tests/test_torch_dryrun_train.py`` so that the two run in parallel
workers (each record is a full-width step counted on fake tensors)."""
import pytest

from repro_torch.launch import dryrun

from torch_lm_cases import one_intra_op_thread  # noqa: F401

SSM_ARCHS = ("rwkv6-3b", "zamba2-1.2b")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_ssm_train_records(multi_pod):
    recs = {a: dryrun.run_one(a, "train_4k", multi_pod=multi_pod,
                              verbose=False) for a in SSM_ARCHS}
    for arch, rec in recs.items():
        assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
        assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        assert 0 < rec["useful_ratio"] < 10
        assert rec["mem_per_device"]["temp_size_bytes"] > 0
    assert recs["rwkv6-3b"]["kernel_units"] == {}
    assert recs["zamba2-1.2b"]["kernel_units"] == {"flash_attention_bh": 7}
