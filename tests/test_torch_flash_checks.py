"""The power of chip_smoke.py's flash-kernel checks, on the CPU: a result
that skipped one key tile for late query rows must fail them, and one
bf16 rounding of the plain result must pass them. The checks hold the
card's flash kernels to their plain versions; these tests hold the
checks themselves, at GPT-2 XL's head dim and sequence (D 64, S 1024)
over two heads, and at OpenLLaMA-3B's head dim (D 100); and the ring
step K5's checks on (m, l, acc) at Phi-3-mini's and OpenLLaMA-3B's head
dims (D 96, 100)."""

import pytest
import torch

from flexflow_tpu_torch.ops.flash_attention import flash_bh_reference


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,keys", [(128, 128), (64, 64)])
def test_skipped_key_tile_fails_the_flash_checks(dtype, rows, keys):
    import chip_smoke
    res = chip_smoke.planted_fault_check(2, 1024, 64, dtype, 12, rows=rows,
                                         keys=keys, device="cpu")
    assert res["rejected"] == {"fwd": True, "dq": True}, res


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_skipped_key_tile_fails_the_flash_checks_at_head_dim_100(dtype):
    """The same at OpenLLaMA-3B's head dim (D 100, S 1024, two heads),
    where K4's bf16 bodies load their tiles by cp.async."""
    import chip_smoke
    res = chip_smoke.planted_fault_check(2, 1024, 100, dtype, 12,
                                         device="cpu")
    assert res["rejected"] == {"fwd": True, "dq": True}, res


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("D", [96, 100])
def test_skipped_key_tile_fails_the_carry_checks(D, carried):
    """K5's checks (max |err| and error norm over m, l and acc) reject a
    causal fold at S 1024 over two heads, bf16, whose last 128 rows left
    out the first 128 keys, from the initial statistics and from a
    carried-in state."""
    import chip_smoke
    res = chip_smoke.planted_carry_fault_check(
        2, 1024, D, torch.bfloat16, 12, carried=carried, device="cpu")
    assert res["rejected"], res


def test_one_bf16_rounding_passes_the_flash_checks():
    """The plain forward on the bf16 inputs computed in fp32 and rounded
    to bf16 once, against the plain forward in bf16 (which rounds p
    before the value product): both within FLASH_TOLS, the error norm and
    LSE_ATOL."""
    import chip_smoke
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(4, 1024, 64, generator=g).bfloat16()
               for _ in range(3))
    out, lse = flash_bh_reference(q, k, v, True, 0.125)
    out32, lse32 = flash_bh_reference(q.float(), k.float(), v.float(), True,
                                      0.125)
    tol = chip_smoke.FLASH_TOLS[torch.bfloat16][0]
    err, ok, rel = chip_smoke._err_ok([(out32.bfloat16(), out)], tol,
                                      (lse32, lse))
    assert ok, (err, rel, chip_smoke._err_parts(out32.bfloat16(), out, tol))
