"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the test, never at import). On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest imports jax, which the
port's machines need not have.)

Tolerances: bf16 outputs atol 2e-2 (one bf16 rounding of values of
order 1), f32 atol 1e-4 (f32 accumulation order), lse atol 1e-3.
"""

from __future__ import annotations

import pytest
import torch

from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,plen", [(64, 16), (128, 8), (16, 4)])
def test_paged_kernel_matches_plain(gen, dtype, dh, plen):
    b, h, per_slot = 4, 2, 6
    npg = b * per_slot
    k = torch.randn((npg, plen, h, dh), generator=gen, device="cuda") \
        .to(dtype)
    v = torch.randn_like(k)
    q = torch.randn((b, h, dh), generator=gen, device="cuda").to(dtype)
    table = torch.full((b, per_slot), npg, dtype=torch.int32)
    pos = torch.tensor([per_slot * plen - 1, plen // 2, 2 * plen, 0],
                       dtype=torch.int32)
    perm = torch.randperm(npg)
    for s in range(3):
        need = int(pos[s]) // plen + 1
        table[s, :need] = perm[s * per_slot:s * per_slot + need].int()
    table[2, 0] = table[0, 0]                 # a shared (CoW) page
    table, pos = table.cuda(), pos.cuda()
    before = pa.LAUNCHES
    out = pa.paged_attention(q, k, v, table, pos)
    ref = pa.paged_attention_reference(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    torch.testing.assert_close(out[:3].float(), ref[:3].float(),
                               atol=ATOL[dtype], rtol=0)
    assert out[3].abs().max().item() == 0.0   # empty slot → zeros


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,causal", [(200, True), (256, False), (64, True)])
def test_flash_kernel_matches_plain(gen, dtype, t, causal):
    b, h, d = 2, 3, 64
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    ref, ref_lse = fa.mha_reference_lse(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    ntc = fa.flash_attention_ntc(*(x.transpose(1, 2) for x in (q, k, v)),
                                 causal=causal)
    torch.testing.assert_close(ntc.transpose(1, 2).float(), ref.float(),
                               atol=ATOL[dtype], rtol=0)
