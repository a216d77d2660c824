"""K13 (``mdta_attention``, ``csrc/mdta.cu``) on the card, whose Gram and
attn . v run on the tensor cores: at the Restormer and PromptIR attention
shapes of ``chip_smoke.py`` [22] (a 128 x 128 forward's (BH, c, L) per
level, and enc1 at the train ymls' batch 8) against its plain version, fp32
and bf16, twice for equal bits, at each tile family forced (the same bits),
the launches of one call as ``mdta.launches_per_call`` reckons them (two
where one chunk and one Gram tile cover a head, else three), none of them a
pass with one block a head; and the widest head the wrapper takes (c 8192)
and more heads than a grid's y or z dimension holds.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor dcpt_tpu; from the
repo root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_k13.py

Limits, relative to max(1, max|ref|), as ``chip_smoke.py`` holds K13
(``K13_TOL``): fp32 1e-4, bf16 2e-2 (the bf16 kernel against the plain version
in fp32 on the same rounded inputs).
"""

import numpy as np
import pytest
import torch

from dcpt_tpu_torch.ops import mdta as tmd
from dcpt_tpu_torch.tools.swin_ab import pass_split

pytestmark = pytest.mark.cuda

LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (BH, c, L, softmax): Restormer's levels (ReLU), PromptIR's dec1 and noise levels (softmax), enc1 at B = 8
SHAPES = [(1, 48, 16384, False), (2, 48, 4096, False), (4, 48, 1024, False), (8, 48, 256, False),
          (1, 96, 16384, True), (4, 176, 256, True), (4, 80, 1024, True), (4, 40, 4096, True), (8, 48, 16384, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, bh, c, length, dtype):
    rng = np.random.default_rng(bh * c + length)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, c, length)).astype(np.float32)).to(device, dtype)
               for _ in range(3))
    t = torch.from_numpy((rng.random((bh, 1, 1)) + 0.5).astype(np.float32)).to(device, dtype)
    return q, k, v, t


def _rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / max(1.0, ref.float().abs().max().item())).item()


@pytest.mark.parametrize("bh,c,length,use_softmax", SHAPES, ids=[f"{b}x{c}x{n}" for b, c, n, _ in SHAPES])
def test_k13_at_the_nets_shapes(cuda, bh, c, length, use_softmax):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, t = _inputs(cuda, bh, c, length, dtype)
        with torch.no_grad():
            got = tmd.mdta_attention(q, k, v, t, use_softmax)
            ref = tmd.mdta_ref(q.float(), k.float(), v.float(), t.float(), use_softmax)
            assert got.dtype == dtype and got.shape == q.shape and torch.isfinite(got.float()).all()
            assert _rel(got, ref) <= LIMIT[dtype], dtype
            assert torch.equal(tmd.mdta_attention(q, k, v, t, use_softmax), got), dtype
            stream = torch.cuda.current_stream().cuda_stream
            for tile in (0, 1):  # each tile family forced (48, 96): the same bits
                assert torch.equal(tmd._launch(tmd._lib(), q, k, v, t, use_softmax, stream, tile=tile), got), tile


def test_k13_launches_per_call(cuda):
    """One call's launches by torch.profiler at enc1 at B = 8, noise_level3 and the latent: as many
    as ``launches_per_call`` reckons, all of ``mdta.cu``'s tensor-core passes and none a
    one-block-a-head pass."""
    for bh, c, length, use_softmax in [(8, 48, 16384, False), (4, 176, 256, True), (8, 48, 256, False)]:
        q, k, v, t = _inputs(cuda, bh, c, length, torch.float32)
        with torch.no_grad():
            names = [name for name, _ in pass_split(lambda: tmd.mdta_attention(q, k, v, t, use_softmax))]
        assert len(names) == tmd.launches_per_call(bh, c, length), (bh, c, length, names)
        assert names[0].startswith("mdta_gram_kernel<") and names[-1].startswith("mdta_av_kernel<"), names
        assert "mdta_attn_kernel" not in " ".join(names), names


def test_k13_widest_head_and_most_heads(cuda):
    """The widest head the wrapper takes (c 8192; from about c 3230 on, the reduce pass takes fewer
    rows a block so that its sums fit in shared memory) and more heads than a grid's y or z holds."""
    for bh, c, length, use_softmax in [(1, 8192, 64, True), (1, 4096, 256, False), (70000, 4, 8, True)]:
        q, k, v, t = _inputs(cuda, bh, c, length, torch.float32)
        with torch.no_grad():
            got = tmd.mdta_attention(q, k, v, t, use_softmax)
            ref = tmd.mdta_ref(q, k, v, t, use_softmax)
            assert torch.isfinite(got).all() and _rel(got, ref) <= LIMIT[torch.float32], (bh, c, length)
            assert torch.equal(tmd.mdta_attention(q, k, v, t, use_softmax), got), (bh, c, length)
