"""The port's CUDA kernels (K1-K14, K5') against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor dcpt_tpu, so it runs
where only PyTorch is installed; from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the suite.)
"""

from unittest import mock

import numpy as np
import pytest
import torch

from dcpt_tpu_torch.archs.nafnet_arch import NAFBlock, NAFNetBaseline
from dcpt_tpu_torch.archs.promptir_arch import PromptIR
from dcpt_tpu_torch.archs import swinir_arch
from dcpt_tpu_torch.archs.restormer_arch import Restormer, TransformerBlock
from dcpt_tpu_torch.archs.swinir_arch import SwinIR
from dcpt_tpu_torch.ops import fused_act as tfa
from dcpt_tpu_torch.ops import layernorm2d as tln
from dcpt_tpu_torch.ops import ln_proj as tln_proj
from dcpt_tpu_torch.ops import mdta as tmd
from dcpt_tpu_torch.ops import mdta_block as tmb
from dcpt_tpu_torch.ops import mdta_block_bwd as tmbb
from dcpt_tpu_torch.ops import naf_block as tnb
from dcpt_tpu_torch.ops import naf_block_bwd as tnbb
from dcpt_tpu_torch.ops import naf_ffn as tnff
from dcpt_tpu_torch.ops import naf_prefix as tnpf
from dcpt_tpu_torch.ops import swin_block_bwd as tsbb
from dcpt_tpu_torch.ops import window_attention as twa
from dcpt_tpu_torch.ops import window_process as twp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _block_inputs(b, h, w, c, seed, device, dtype):
    """x and the 18 parameters in the op's layout, beta / gamma / norm affines random."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.5, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(device, dtype)

    s = c ** -0.5
    x = r(b, h, w, c, scale=1.0)
    return x, [r(c, shift=1.0), r(c), r(c, 2 * c, scale=s), r(2 * c), r(3, 3, 2 * c, scale=1 / 3), r(2 * c),
               r(c, c, scale=s), r(c), r(c, c, scale=s), r(c), r(c), r(c, shift=1.0), r(c), r(c, 2 * c, scale=s),
               r(2 * c), r(c, c, scale=s), r(c), r(c)]


@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 16, 16, 64), torch.float32, 1e-4),
    ((2, 24, 40, 64), torch.float32, 1e-4),   # ragged tiles
    ((1, 64, 64, 128), torch.float32, 1e-4),  # 32-pixel P2 tiles
    ((1, 1, 1, 1024), torch.float32, 1e-4),   # the middle block of a 16 x 16 input
    ((2, 16, 16, 512), torch.bfloat16, 2e-2),
])
def test_k1_matches_twin(cuda, shape, dtype, tol):
    """fp32 math in both; error relative to max(1, max|ref|). The bf16 kernel is held
    against the twin in fp32 on the same rounded inputs."""
    x, params = _block_inputs(*shape, seed=2, device=cuda, dtype=dtype)
    before = tnb.naf_block_fused.launches
    z = tnb.naf_block_fused(x, *params)
    assert tnb.naf_block_fused.launches == before + 1
    ref = tnb.naf_block_ref(x.float(), *[p.float() for p in params])
    torch.cuda.synchronize()
    assert z.shape == x.shape and z.dtype == dtype
    err = (z.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    assert err <= tol, err


def test_k1_raises_on_what_it_does_not_take(cuda):
    x, params = _block_inputs(1, 4, 4, 8, seed=0, device=cuda, dtype=torch.float32)
    before = tnb.naf_block_fused.launches
    with pytest.raises(ValueError, match="C in 64"):
        tnb.naf_block_fused(x, *params)
    assert tnb.naf_block_fused.launches == before


def _plain_forward(self, inp):
    x = inp.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    return tnb.naf_block_ref(x, *self.op_args(), self.norm1.eps).permute(0, 3, 1, 2)


def _seeded_net(device):
    """A width-64 NAFNetBaseline with random beta / gamma / norm affines (at init
    every block is the identity, which would hide the kernel's body)."""
    torch.manual_seed(0)
    net = NAFNetBaseline(width=64, middle_blk_num=1, enc_blk_nums=[1, 1], dec_blk_nums=[1, 1])
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("beta", "gamma")) or ".norm" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5 + (1.0 if name.endswith("norm1.weight") else 0.0))
    return net.to(device).eval()


def test_network_kernel_path_matches_plain_path(cuda):
    """One kernel call per NAFBlock, and the output of the plain path within 1e-4 (fp32)."""
    net = _seeded_net(cuda)
    x = torch.rand(2, 3, 48, 40, generator=torch.Generator().manual_seed(2)).to(cuda)
    before = tnb.naf_block_fused.launches
    with torch.inference_mode():
        out, _ = net(x)
        with mock.patch.object(NAFBlock, "forward", _plain_forward):
            ref, _ = net(x)
    assert tnb.naf_block_fused.launches == before + 5
    assert (out - ref).abs().max().item() <= 1e-4


def test_network_runs_k1_in_bf16(cuda):
    """The bf16 network calls K1 in bf16 at every block. Against the plain path in
    fp32 on the same bf16-rounded weights and input, the error relative to
    max(1, max|ref|) stays within 5e-2: about a dozen bf16 roundings (2^-8 each)
    lie in series between input and output."""
    net = _seeded_net(cuda).to(torch.bfloat16)
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(2)).to(cuda, torch.bfloat16)
    before = tnb.naf_block_fused.launches
    with torch.inference_mode():
        out, _ = net(x)
        assert tnb.naf_block_fused.launches == before + 5
        net.float()
        with mock.patch.object(NAFBlock, "forward", _plain_forward):
            ref, _ = net(x.float())
    assert out.dtype == torch.bfloat16
    err = (out.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    assert err <= 5e-2, err


def _rel(a, ref):
    return (a - ref).abs().max().item() / max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 24, 40, 64), (1, 64, 64, 128), (1, 1, 1, 1024),
                                   (2, 5, 11, 512)])
def test_k2_matches_plain_backward(cuda, shape):
    """K2 from K1's residuals against naf_block_bwd_ref on all 19 cotangents, fp32:
    error relative to max(1, max|ref|) within 1e-3 (weight gradients sum over
    the pixels in another order)."""
    x, params = _block_inputs(*shape, seed=3, device=cuda, dtype=torch.float32)
    dz = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    _, res = tnb._kernel_forward(x, params, 1e-6, residuals=True)
    *maps, pooled, att = res
    before = tnbb.naf_block_bwd.launches
    got = tnbb.naf_block_bwd(x, *params, pooled, att, dz, maps)
    assert tnbb.naf_block_bwd.launches == before + 1
    ref = tnbb.naf_block_bwd_ref(x, *params, pooled, att, dz)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert _rel(a, b) <= 1e-3, (i, _rel(a, b))


def test_k2_is_deterministic(cuda):
    x, params = _block_inputs(2, 16, 16, 256, seed=5, device=cuda, dtype=torch.float32)
    dz = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    _, res = tnb._kernel_forward(x, params, 1e-6, residuals=True)
    *maps, pooled, att = res
    first = tnbb.naf_block_bwd(x, *params, pooled, att, dz, maps)
    second = tnbb.naf_block_bwd(x, *params, pooled, att, dz, maps)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("rows,c,dtype,tol", [(8192, 512, torch.float32, 1e-4), (2048, 1024, torch.float32, 1e-4),
                                              (512, 512, torch.float32, 1e-4), (37, 640, torch.float32, 1e-4),
                                              (8192, 512, torch.bfloat16, 2e-2), (37, 640, torch.bfloat16, 2e-2)])
def test_k3_matches_plain(cuda, rows, c, dtype, tol):
    """K3 forward and backward against the plain versions within ``tol`` relative
    to max(1, max|ref|); in bf16 the outputs and gradients are bf16, y and
    1/sigma fp32."""
    gen = torch.Generator().manual_seed(rows + c)
    x = (torch.randn(rows, c, generator=gen) * 3 + 1).to(cuda, dtype)
    w, b = torch.randn(c, generator=gen).to(cuda, dtype), torch.randn(c, generator=gen).to(cuda, dtype)
    g = torch.randn(rows, c, generator=gen).to(cuda, dtype)
    out, y, rsig = tln._launch_fwd(tln._lib(), x, w, b, 1e-6, tln._stream(), residuals=True)
    gx, gw, gb = tln._launch_bwd(tln._lib(), g, y, rsig, w, tln._stream())
    ref_out, ref_y, ref_rsig = tln.layer_norm_2d_ref(x, w, b, 1e-6)
    ref_gx, ref_gw, ref_gb = tln.layer_norm_2d_bwd_ref(g, ref_y, ref_rsig, w)
    torch.cuda.synchronize()
    assert {t.dtype for t in (out, gx, gw, gb)} == {dtype} and y.dtype == torch.float32
    for a, r in [(out, ref_out), (y, ref_y), (gx, ref_gx), (gw, ref_gw), (gb, ref_gb)]:
        assert _rel(a.float(), r.float()) <= tol, _rel(a.float(), r.float())


def test_k3_function_counts_launches(cuda):
    x = torch.randn(2, 4, 4, 512, device=cuda, requires_grad=True)
    w = torch.randn(512, device=cuda, requires_grad=True)
    b = torch.randn(512, device=cuda, requires_grad=True)
    fwd, bwd = tln.layer_norm_2d.launches, tln.layer_norm_2d.bwd_launches
    tln.layer_norm_2d(x, w, b).square().sum().backward()
    assert (tln.layer_norm_2d.launches, tln.layer_norm_2d.bwd_launches) == (fwd + 1, bwd + 1)
    ref = torch.nn.functional.layer_norm(x.detach(), (512,), w.detach(), b.detach(), 1e-6)
    assert _rel(tln.layer_norm_2d(x.detach(), w.detach(), b.detach()), ref) <= 1e-4


def test_network_gradients_match_plain_path(cuda):
    """A backward through NAFNetBaseline on the card runs K1 and K2 at every block
    and gives every parameter a gradient within 1e-3 (relative to the tensor's
    max|ref|) of the plain path's autograd."""
    net = _seeded_net(cuda).train()
    x = torch.rand(2, 3, 48, 40, generator=torch.Generator().manual_seed(7)).to(cuda)
    before = (tnb.naf_block_fused.launches, tnbb.naf_block_bwd.launches)
    out, _ = net(x)
    out.square().mean().backward()
    assert (tnb.naf_block_fused.launches, tnbb.naf_block_bwd.launches) == (before[0] + 5, before[1] + 5)
    got = {n: p.grad.clone() for n, p in net.named_parameters()}
    net.zero_grad()
    with mock.patch.object(NAFBlock, "forward", _plain_forward):
        ref_out, _ = net(x)
        ref_out.square().mean().backward()
    for n, p in net.named_parameters():
        assert got[n] is not None and p.grad is not None, n
        err = (got[n] - p.grad).abs().max().item() / max(p.grad.abs().max().item(), 1e-12)
        assert err <= 1e-3, (n, err)


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 5, 11, 512), (1, 1, 1, 1024)])
def test_bf16_block_trains_through_k1_and_k2(cuda, shape):
    """A bf16 NAFBlock under autograd is NAFBlockFunction: K1 in bf16 forward, K2 in
    bf16 backward; every cotangent bf16 and within 2e-2 of max(1, max|ref|) of the
    plain backward (fp32 math on the same bf16 inputs); K2 twice gives equal bits."""
    x, params = _block_inputs(*shape, seed=9, device=cuda, dtype=torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    dz = torch.randn(shape, generator=torch.Generator().manual_seed(10)).to(cuda, torch.bfloat16)
    before = (tnb.naf_block_fused.launches, tnbb.naf_block_bwd.launches)
    z = tnb.naf_block_fused(*leaves)
    z.backward(dz)
    assert (tnb.naf_block_fused.launches, tnbb.naf_block_bwd.launches) == (before[0] + 1, before[1] + 1)
    _, (*maps, pooled, att) = tnb._kernel_forward(x, params, 1e-6, residuals=True)
    ref = tnbb.naf_block_bwd_ref(x, *params, pooled, att, dz)
    again = tnbb.naf_block_bwd(x, *params, pooled, att, dz, maps)
    torch.cuda.synchronize()
    for i, (leaf, r, a) in enumerate(zip(leaves, ref, again)):
        assert leaf.grad.dtype == torch.bfloat16 and torch.equal(leaf.grad, a), i
        assert _rel(leaf.grad.float(), r.float()) <= 2e-2, (i, _rel(leaf.grad.float(), r.float()))


# (B, H, W) at the c = 512 stage: a 128 x 128 input's 16 x 16 at the eval's B = 1 and the train
# yml's B = 8, and a ragged 120 x 72 image's 15 x 9
@pytest.mark.parametrize("b,h,w", [(1, 16, 16), (8, 16, 16), (1, 15, 9)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k4_k5_match_plain(cuda, b, h, w, dtype, tol):
    """K4 (naf_prefix) and K5 (naf_ffn) against their plain versions in fp32 on the
    same rounded inputs, within ``tol`` relative to max(1, max|ref|); each launch
    counted, and each twice with equal bits."""
    x, p = _block_inputs(b, h, w, 512, seed=h + w, device=cuda, dtype=dtype)
    xf, pf = x.float(), [t.float() for t in p]
    before = (tnpf.naf_prefix.launches, tnff.naf_ffn.launches)
    g, z = tnpf.naf_prefix(x, *p[:6]), tnff.naf_ffn(x, *p[11:])
    assert (tnpf.naf_prefix.launches, tnff.naf_ffn.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(g, tnpf.naf_prefix(x, *p[:6])) and torch.equal(z, tnff.naf_ffn(x, *p[11:]))
    ref_g, ref_z = tnpf.naf_prefix_ref(xf, *pf[:6]), tnff.naf_ffn_ref(xf, *pf[11:])
    torch.cuda.synchronize()
    assert g.dtype == z.dtype == dtype and g.shape == ref_g.shape and z.shape == ref_z.shape
    assert _rel(g.float(), ref_g) <= tol and _rel(z.float(), ref_z) <= tol


def test_k4_k5_functions_train(cuda):
    """Under autograd K4 and K5 run forward and the plain VJP backward."""
    x, p = _block_inputs(2, 16, 16, 512, seed=1, device=cuda, dtype=torch.float32)
    leaves = [t.clone().requires_grad_() for t in (x, *p)]
    before = (tnpf.naf_prefix.launches, tnff.naf_ffn.launches)
    (tnpf.naf_prefix(leaves[0], *leaves[1:7]).square().sum() + tnff.naf_ffn(leaves[0], *leaves[12:]).sum()).backward()
    assert (tnpf.naf_prefix.launches, tnff.naf_ffn.launches) == (before[0] + 1, before[1] + 1)
    refs = [t.clone().requires_grad_() for t in (x, *p)]
    (tnpf.naf_prefix_ref(refs[0], *refs[1:7]).square().sum() + tnff.naf_ffn_ref(refs[0], *refs[12:]).sum()).backward()
    for a, r in zip(leaves, refs):
        if r.grad is not None:
            assert _rel(a.grad, r.grad) <= 1e-4


def _mdta_inputs(b, h, w, c, heads, seed, device, dtype):
    """x and K6's 11 parameters in the op's layout, weights of unit gain, F = int(2.66 C)."""
    rng = np.random.default_rng(seed)
    f = int(c * 2.66)

    def r(*shape, scale=0.3, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(device, dtype)

    return r(b, h, w, c, scale=1.0), [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3, 3, 3 * c, scale=1 / 3),
                                      r(heads, 1, 1, shift=1.0), r(c, c, scale=c ** -0.5), r(c, shift=1.0), r(c),
                                      r(c, 2 * f, scale=c ** -0.5), r(3, 3, 2 * f, scale=1 / 3),
                                      r(f, c, scale=f ** -0.5)]


# (B, H, W, C, heads), flavour (use_softmax, ln_bias, eps), dtype, limit relative to max(1, max|ref|)
@pytest.mark.parametrize("shape,flavour,dtype,tol", [
    ((1, 64, 64, 48, 1), (False, False, 1e-6), torch.float32, 1e-4),    # Restormer level 1 (64-pixel tiles)
    ((2, 16, 16, 384, 8), (False, False, 1e-6), torch.float32, 1e-4),   # the latent, two images
    ((1, 61, 41, 96, 1), (False, False, 1e-6), torch.float32, 1e-4),    # ragged, one 96-wide head
    ((1, 32, 32, 320, 4), (True, True, 1e-5), torch.float32, 1e-4),     # PromptIR noise_level2 (ch 80)
    ((1, 16, 16, 704, 4), (True, True, 1e-5), torch.float32, 1e-4),     # noise_level3 (ch 176, F 1872)
    ((1, 1, 1, 160, 4), (True, True, 1e-5), torch.float32, 1e-4),       # a 1 x 1 map
    ((1, 32, 32, 48, 1), (True, True, 1e-5), torch.bfloat16, 2e-2),
])
def test_k6_matches_plain(cuda, shape, flavour, dtype, tol):
    """fp32 math in both; the bf16 kernel is held against the plain version in fp32
    on the same rounded inputs."""
    b, h, w, c, heads = shape
    x, params = _mdta_inputs(b, h, w, c, heads, seed=c, device=cuda, dtype=dtype)
    before = tmb.mdta_block_fused.launches
    with torch.no_grad():
        z = tmb.mdta_block_fused(x, *params, heads, *flavour)
    assert tmb.mdta_block_fused.launches == before + 1
    ref = tmb.mdta_block_ref(x.float(), *[p.float() for p in params], heads, *flavour)
    torch.cuda.synchronize()
    assert z.shape == x.shape and z.dtype == dtype
    assert _rel(z.float(), ref) <= tol, _rel(z.float(), ref)


def test_k6_is_deterministic_and_returns_its_residuals(cuda):
    x, params = _mdta_inputs(1, 40, 40, 96, 2, seed=3, device=cuda, dtype=torch.float32)
    first, res = tmb._kernel_forward(x, params, 2, False, False, 1e-6, residuals=True)
    second = tmb._kernel_forward(x, params, 2, False, False, 1e-6)
    assert torch.equal(first, second)
    gram, qn2, kn2, attn, t, qkv, o, y, u, g = res
    assert gram.shape == (1, 96, 48) and qn2.shape == kn2.shape == (1, 96)
    assert attn.shape == (1, 96, 96) and not attn[0, :48, 48:].any()
    assert t.shape == qkv.shape == (1, 40, 40, 288) and o.shape == y.shape == x.shape
    assert u.shape == (1, 40, 40, 510) and g.shape == (1, 40, 40, 255)


# (B, H, W, C, heads), flavour: Restormer's first stage in its flavour at B = 2, and a
# ragged map with two 48-wide heads in PromptIR's
@pytest.mark.parametrize("shape,flavour", [((2, 32, 32, 48, 1), (False, False, 1e-6)),
                                           ((1, 21, 13, 96, 2), (True, True, 1e-5))])
def test_bf16_transformer_block_trains_through_k6_and_k7(cuda, shape, flavour):
    """A bf16 TransformerBlock under autograd is MDTABlockFunction: K6 in bf16 keeping
    fp32 residuals (the bits its fp32 entry writes for the same values), then K7 in
    bf16; every cotangent bf16 and within 2e-2 of max(1, max|ref|) of the plain
    backward (fp32 math on the same bf16 inputs and residuals); K7 twice gives equal bits."""
    b, h, w, c, heads = shape
    x, params = _mdta_inputs(b, h, w, c, heads, seed=5, device=cuda, dtype=torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    dz = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).to(cuda, torch.bfloat16)
    before = (tmb.mdta_block_fused.launches, tmbb.mdta_block_bwd.launches)
    tmb.mdta_block_fused(leaves[0], *leaves[1:], heads, *flavour).backward(dz)
    assert (tmb.mdta_block_fused.launches, tmbb.mdta_block_bwd.launches) == (before[0] + 1, before[1] + 1)
    _, res = tmb._kernel_forward(x, params, heads, *flavour, residuals=True)
    _, res32 = tmb._kernel_forward(x.float(), [p.float() for p in params], heads, *flavour, residuals=True)
    again = tmbb.mdta_block_bwd(x, *params, dz, res, heads, *flavour)
    ref = tmbb.mdta_block_bwd_ref(x, *params, *res[:4], dz, heads, *flavour)
    torch.cuda.synchronize()
    assert all(r.dtype == torch.float32 and torch.equal(r, r32) for r, r32 in zip(res, res32))
    for i, (leaf, r, a) in enumerate(zip(leaves, ref, again)):
        assert leaf.grad.dtype == torch.bfloat16 and torch.equal(leaf.grad, a), i
        assert _rel(leaf.grad.float(), r.float()) <= 2e-2, (i, _rel(leaf.grad.float(), r.float()))


# (B, H, W, C, heads), flavour: a Restormer stage, a ragged map with a 96-wide head,
# PromptIR's noise_level2 and a 3 x 2 map.  Not a 1 x 1 map: there q / |q| over
# the pixels is sign(q), so dq and dk are an exact cancellation of two terms of
# size 1 / |q| and both versions return float noise of that size.
@pytest.mark.parametrize("shape,flavour", [
    ((2, 32, 32, 192, 4), (False, False, 1e-6)),
    ((1, 61, 41, 96, 1), (False, False, 1e-6)),
    ((1, 32, 32, 320, 4), (True, True, 1e-5)),
    ((2, 3, 2, 160, 4), (True, True, 1e-5)),
])
def test_k7_matches_plain_backward(cuda, shape, flavour):
    """All 12 cotangents from K6's residuals within 1e-3 of max(1, max|ref|) (weight
    gradients sum over pixels in another order), and the same bits twice."""
    b, h, w, c, heads = shape
    x, params = _mdta_inputs(b, h, w, c, heads, seed=c + h, device=cuda, dtype=torch.float32)
    dz = torch.randn(x.shape, generator=torch.Generator().manual_seed(c)).to(cuda)
    _, res = tmb._kernel_forward(x, params, heads, *flavour, residuals=True)
    before = tmbb.mdta_block_bwd.launches
    got = tmbb.mdta_block_bwd(x, *params, dz, res, heads, *flavour)
    again = tmbb.mdta_block_bwd(x, *params, dz, res, heads, *flavour)
    assert tmbb.mdta_block_bwd.launches == before + 2
    ref = tmbb.mdta_block_bwd_ref(x, *params, *res[:4], dz, heads, *flavour)
    torch.cuda.synchronize()
    for i, (a, r, a2) in enumerate(zip(got, ref, again)):
        assert a.shape == r.shape and torch.isfinite(a).all(), i
        assert _rel(a, r) <= 1e-3, (i, _rel(a, r))
        assert torch.equal(a, a2), i


def test_restormer_trains_through_k6_and_k7(cuda):
    """Width 8, one block per level: under autograd every TransformerBlock is an
    MDTABlockFunction (K6 forward, K7 backward, one launch each), and the
    gradients match the plain path's within 1e-3 of each tensor's max|ref|."""
    torch.manual_seed(0)
    net = Restormer(dim=8, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1, heads=[1, 2, 4, 8]).to(cuda)
    x = torch.rand(2, 3, 40, 48, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = (tmb.mdta_block_fused.launches, tmbb.mdta_block_bwd.launches)
    out, taps = net(x)
    # each level's tap is the (B, C, H, W) view of its last block's output
    assert all(type(t.grad_fn.next_functions[0][0]).__name__ == "MDTABlockFunctionBackward" for t in taps.values())
    out.square().mean().backward()
    assert (tmb.mdta_block_fused.launches, tmbb.mdta_block_bwd.launches) == (before[0] + 8, before[1] + 8)
    got = {n: p.grad.clone() for n, p in net.named_parameters()}
    net.zero_grad()
    with mock.patch.object(TransformerBlock, "forward", _plain_transformer_forward):
        ref_out, _ = net(x)
        ref_out.square().mean().backward()
    for n, p in net.named_parameters():
        assert got[n] is not None and p.grad is not None, n
        assert (got[n] - p.grad).abs().max().item() <= 1e-3 * max(p.grad.abs().max().item(), 1e-12), n


def _plain_transformer_forward(self, inp):
    x = inp.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    return tmb.mdta_block_ref(x, *self.op_args(), self.attn.num_heads, self.attn.use_softmax, self.norm1.with_bias,
                              self.norm1.eps).permute(0, 3, 1, 2)


@pytest.mark.parametrize("arch,blocks", [("Restormer", 8), ("PromptIR", 11)])
def test_transformer_nets_kernel_path_matches_plain_path(cuda, arch, blocks):
    """Width 8, one block per level: one K6 call per TransformerBlock, and the
    output of the plain path within 1e-4 (fp32, TF32 off) on a ragged input."""
    torch.manual_seed(0)
    cfg = dict(dim=8, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1, heads=[1, 2, 4, 8])
    net = (Restormer(**cfg) if arch == "Restormer" else PromptIR(**cfg)).to(cuda).eval()
    x = torch.rand(1, 3, 48, 40, generator=torch.Generator().manual_seed(2)).to(cuda)
    before = tmb.mdta_block_fused.launches
    with torch.inference_mode():
        out, _ = net(x)
        assert tmb.mdta_block_fused.launches == before + blocks
        with mock.patch.object(TransformerBlock, "forward", _plain_transformer_forward):
            ref, _ = net(x)
    assert _rel(out, ref) <= 1e-4


def _swin_inputs(b, h, w, c, heads, hidden, seed, device, dtype):
    """x and the 12 Swin block parameters in the op's (in, out) layout, random LayerNorm affines."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.3, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(device, dtype)

    return r(b, h, w, c, scale=1.0), [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3 * c),
                                      r(c, c, scale=c ** -0.5), r(c), r(c, shift=1.0), r(c),
                                      r(c, hidden, scale=c ** -0.5), r(hidden), r(hidden, c, scale=hidden ** -0.5), r(c)]


# (B, H, W, C, heads, ws, shift), dtype, limit relative to max(1, max|ref|): the
# shipped width at both shifts, a ragged 15 x 9 window grid, a tiny width with 4 x 4 windows
SWIN_CASES = [
    ((1, 64, 64, 180, 6, 8, 0), torch.float32, 1e-4),
    ((1, 64, 64, 180, 6, 8, 4), torch.float32, 1e-4),
    ((2, 120, 72, 180, 6, 8, 4), torch.float32, 1e-4),
    ((1, 8, 12, 12, 2, 4, 2), torch.float32, 1e-4),
    ((1, 64, 64, 180, 6, 8, 4), torch.bfloat16, 2e-2),
]


@pytest.mark.parametrize("shape,dtype,tol", SWIN_CASES)
def test_k8_matches_plain(cuda, shape, dtype, tol):
    """One launch, within tol of swin_block_map_ref (fp32 on the same rounded inputs), the same bits twice."""
    b, h, w, c, heads, ws, shift = shape
    x, params = _swin_inputs(b, h, w, c, heads, 2 * c, seed=c + shift, device=cuda, dtype=dtype)
    before = twa.fused_swin_block.launches
    with torch.no_grad():
        z = twa.fused_swin_block(x, *params, heads, ws, shift)
        again = twa.fused_swin_block(x, *params, heads, ws, shift)
    assert twa.fused_swin_block.launches == before + 2
    ref = twa.swin_block_map_ref(x.float(), *[p.float() for p in params], heads, ws, shift)
    torch.cuda.synchronize()
    assert z.shape == x.shape and z.dtype == dtype
    assert torch.equal(z, again)
    assert _rel(z.float(), ref) <= tol, _rel(z.float(), ref)


@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("shape,dtype,tol", SWIN_CASES)
def test_k10_matches_plain(cuda, shape, dtype, tol, with_ln):
    b, h, w, c, heads, ws, shift = shape
    x, params = _swin_inputs(b, h, w, c, heads, 2 * c, seed=c + shift + 1, device=cuda, dtype=dtype)
    before = twa.fused_window_attention.launches
    with torch.no_grad():
        if with_ln:
            out = twa.fused_window_attention_ln(x, *params[:6], heads, ws, shift)
            again = twa.fused_window_attention_ln(x, *params[:6], heads, ws, shift)
        else:
            out = twa.fused_window_attention(x, *params[2:6], heads, ws, shift)
            again = twa.fused_window_attention(x, *params[2:6], heads, ws, shift)
    assert twa.fused_window_attention.launches == before + 2
    pf = [p.float() for p in params]
    ln = (pf[0], pf[1], 1e-5) if with_ln else None
    ref = twa.window_attention_map_ref(x.float(), *pf[2:6], heads, ws, shift, ln)
    torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == dtype
    assert torch.equal(out, again)
    assert _rel(out.float(), ref) <= tol, _rel(out.float(), ref)


def test_bf16_swin_block_trains_through_k8_and_k9(cuda):
    """A bf16 Swin block under autograd at the shipped width is SwinBlockFunction:
    K8 then K9 in bf16; every cotangent bf16 and within 2e-2 of max(1, max|ref|)
    of the plain backward (fp32 math on the same bf16 inputs); K9 twice gives
    equal bits.  On the DCPT_TPU_SWIN_BLOCK=0 route the attention branch is
    WindowAttentionFunction (K10 in bf16, the plain version's VJP in bf16), its
    cotangents within 2e-2 of the fp32 VJP on the same values."""
    b, h, w, c, heads, hidden, ws, shift = 2, 16, 16, 180, 6, 360, 8, 4
    x, params = _swin_inputs(b, h, w, c, heads, hidden, seed=7, device=cuda, dtype=torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    dz = torch.randn(x.shape, generator=torch.Generator().manual_seed(8)).to(cuda, torch.bfloat16)
    before = (twa.fused_swin_block.launches, tsbb.swin_block_bwd.launches)
    twa.fused_swin_block(leaves[0], *leaves[1:], heads, ws, shift).backward(dz)
    assert (twa.fused_swin_block.launches, tsbb.swin_block_bwd.launches) == (before[0] + 1, before[1] + 1)
    again = tsbb.swin_block_bwd(x, *params, dz, heads, ws, shift)
    ref = tsbb.swin_block_bwd_ref(x, *params, dz, heads, ws, shift)
    torch.cuda.synchronize()
    for i, (leaf, r, a) in enumerate(zip(leaves, ref, again)):
        assert leaf.grad.dtype == torch.bfloat16 and torch.equal(leaf.grad, a), i
        assert _rel(leaf.grad.float(), r.float()) <= 2e-2, (i, _rel(leaf.grad.float(), r.float()))

    attn = [x, *params[:6]]  # x, LN1's weight and bias, qkv and proj

    def branch_grads(tensors):
        leaves = [t.clone().requires_grad_() for t in tensors]
        twa.fused_window_attention_ln(leaves[0], *leaves[1:], heads, ws, shift).backward(dz.to(tensors[0].dtype))
        return [t.grad for t in leaves]

    before = twa.fused_window_attention.launches
    got = branch_grads(attn)
    assert twa.fused_window_attention.launches == before + 1
    want = branch_grads([t.float() for t in attn])
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and _rel(g.float(), r) <= 2e-2, (i, _rel(g.float(), r))


# (B, H, W, C, heads, ws, shift): the shipped width across the seam, a ragged
# 15 x 9 window grid, a tiny width with 4 x 4 windows
K9_CASES = [(2, 64, 64, 180, 6, 8, 4), (2, 120, 72, 180, 6, 8, 4), (1, 8, 12, 12, 2, 4, 2)]


@pytest.mark.parametrize("shape", K9_CASES)
def test_k9_matches_plain(cuda, shape):
    """One launch a call; all 13 cotangents within 1e-3 of swin_block_bwd_ref
    relative to max(1, max|ref|) (K7's limit), the same bits twice."""
    b, h, w, c, heads, ws, shift = shape
    x, params = _swin_inputs(b, h, w, c, heads, 2 * c, seed=c + shift + 2, device=cuda, dtype=torch.float32)
    dz = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    before = tsbb.swin_block_bwd.launches
    got = tsbb.swin_block_bwd(x, *params, dz, heads, ws, shift)
    again = tsbb.swin_block_bwd(x, *params, dz, heads, ws, shift)
    assert tsbb.swin_block_bwd.launches == before + 2
    ref = tsbb.swin_block_bwd_ref(x, *params, dz, heads, ws, shift)
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, ref):
        assert g.shape == r.shape and torch.equal(g, a)
        assert _rel(g, r) <= 1e-3, _rel(g, r)


@pytest.mark.parametrize("route", ["K8", "K10"])
def test_swin_routes_under_autograd(cuda, route):
    """fp32 under autograd: the K8 route runs one K8 and one K9 launch a block
    (SwinBlockFunction), the K10 route one K10 launch and the plain VJP
    (WindowAttentionFunction); the output and every gradient within 1e-4 of
    autograd through the plain version in float64."""
    b, h, w, c, heads, ws, shift = 2, 16, 24, 180, 6, 8, 4
    x, params = _swin_inputs(b, h, w, c, heads, 2 * c, seed=5, device=cuda, dtype=torch.float32)
    if route == "K10":
        params = params[:6]
    leaves = [t.requires_grad_() for t in [x, *params]]
    counter = twa.fused_swin_block if route == "K8" else twa.fused_window_attention
    before = (counter.launches, tsbb.swin_block_bwd.launches)
    if route == "K8":
        out = twa.fused_swin_block(*leaves, heads, ws, shift)
    else:
        out = twa.fused_window_attention_ln(*leaves, heads, ws, shift)
    dz = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    got = torch.autograd.grad(out, leaves, dz)
    assert (counter.launches, tsbb.swin_block_bwd.launches) == (before[0] + 1, before[1] + (route == "K8"))
    ref_leaves = [t.detach().double().requires_grad_() for t in leaves]
    if route == "K8":
        ref = twa.swin_block_map_ref(*ref_leaves, heads, ws, shift)
    else:
        ref = twa.window_attention_map_ref(ref_leaves[0], *ref_leaves[3:], heads, ws, shift,
                                           (ref_leaves[1], ref_leaves[2], 1e-5))
    want = torch.autograd.grad(ref, ref_leaves, dz.double())
    assert _rel(out.double(), ref) <= 1e-4
    for g, r in zip(got, want):
        assert _rel(g.double(), r) <= 1e-4, _rel(g.double(), r)


def _plain_swin_forward(self, x):
    return twa.swin_block_map_ref(x, *self.op_args(), self.num_heads, self.window_size, self.shift_size)


@pytest.mark.parametrize("block_kernel", [True, False])
def test_swinir_kernel_path_matches_plain_path(cuda, monkeypatch, block_kernel):
    """Embed 12, two RSTBs of two blocks: one K8 call per block (or one K10 call
    with DCPT_TPU_SWIN_BLOCK=0), and the plain path's output within 1e-4 on a ragged input."""
    torch.manual_seed(0)
    monkeypatch.setattr(swinir_arch, "SWIN_BLOCK_KERNEL", block_kernel)
    net = SwinIR(img_size=16, embed_dim=12, depths=[2, 2], num_heads=[2, 2], window_size=4).to(cuda).eval()
    x = torch.rand(1, 3, 20, 12, generator=torch.Generator().manual_seed(2)).to(cuda)
    counter = twa.fused_swin_block if block_kernel else twa.fused_window_attention
    before = counter.launches
    with torch.inference_mode():
        out, _ = net(x)
        assert counter.launches == before + 4
        with mock.patch.object(swinir_arch.SwinTransformerBlock, "forward", _plain_swin_forward):
            ref, _ = net(x)
    assert _rel(out, ref) <= 1e-4


# ---- the standalone ops of dcpt_tpu's public API: K11, K12, K13, K14 and K5' ----

STANDALONE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape,shift", [((2, 128, 128, 180), 4), ((1, 128, 128, 180), 0), ((2, 24, 16, 7), 11)])
def test_window_process_is_exact(cuda, dtype, shape, shift):
    """K11: the partition equals torch.roll + view bit for bit, the reverse undoes
    it, two runs give the same bits; each call launches once."""
    x = (torch.randn(*shape, generator=torch.Generator().manual_seed(1)) * 30).to(cuda, dtype)
    before = (twp.window_partition_fused.launches, twp.window_reverse_fused.launches)
    win = twp.window_partition_fused(x, 8, shift)
    back = twp.window_reverse_fused(win, 8, shape[1], shape[2], shift)
    assert (twp.window_partition_fused.launches, twp.window_reverse_fused.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(win, twp.window_partition_ref(x, 8, shift)) and torch.equal(back, x)
    assert torch.equal(win, twp.window_partition_fused(x, 8, shift))
    with pytest.raises(ValueError, match="multiples"):
        twp.window_partition_fused(x[:, :-1], 8, shift)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 64, 512), (3, 5, 37)])
def test_fused_act_forward_and_backward(cuda, dtype, shape):
    """K12 forward and backward against the plain versions on the card, bit for bit
    (both round after every operation), twice for equal bits; gb as the sum of gx."""
    gen = torch.Generator().manual_seed(2)
    x, g = (torch.randn(*shape, generator=gen).to(cuda, dtype) for _ in range(2))
    b = torch.randn(shape[-1], generator=gen).to(cuda, dtype)
    x[0, 0] = -b
    xr, br = x.clone().requires_grad_(), b.clone().requires_grad_()
    before = (tfa.fused_bias_leaky_relu.launches, tfa.fused_bias_leaky_relu.bwd_launches)
    out = tfa.fused_bias_leaky_relu(xr, br)
    out.backward(g)
    assert (tfa.fused_bias_leaky_relu.launches, tfa.fused_bias_leaky_relu.bwd_launches) == (before[0] + 1,
                                                                                          before[1] + 1)
    ref, mask = tfa.fused_bias_leaky_relu_ref(x, b)
    gx = tfa.fused_bias_leaky_relu_bwd_ref(g, mask)
    assert torch.equal(out, ref) and torch.equal(xr.grad, gx)
    assert _rel(br.grad.float(), gx.float().reshape(-1, shape[-1]).sum(0)) <= STANDALONE_TOL[dtype]
    assert torch.equal(tfa.fused_bias_leaky_relu(x, b), out.detach())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op,rows,c,c_out,biasfree", [("ln_proj", 16384, 48, 144, True),
                                                      ("ln_proj", 4096, 96, 254, False),
                                                      ("ln_proj", 37, 704, 70, False),
                                                      ("naf_expand", 256, 512, 1024, False),
                                                      ("naf_expand", 135, 37, 70, False)])
def test_ln_proj_and_naf_expand(cuda, dtype, op, rows, c, c_out, biasfree):
    """K14 and K5' against their plain versions (in fp32 on the same rounded
    inputs), twice for equal bits, and every gradient through their autograd
    Functions (the plain versions' VJPs) against the plain versions'."""
    gen = torch.Generator().manual_seed(3)

    def r(*s, scale=1.0, shift=0.0):
        return (torch.randn(*s, generator=gen) * scale + shift).to(cuda, dtype)

    x = r(rows, c, scale=2.0, shift=0.5)
    params = [r(c, scale=0.3, shift=1.0), torch.zeros(c, device=cuda, dtype=dtype) if biasfree else r(c, scale=0.3),
              r(c, c_out, scale=c ** -0.5)]
    if op == "ln_proj":
        fn, ref_fn, counter = (lambda *a: tln_proj.fused_ln_proj(*a, 1e-6, biasfree),
                               lambda *a: tln_proj.ln_proj_ref(*a, 1e-6, biasfree), tln_proj.fused_ln_proj)
    else:
        params.append(r(c_out, scale=0.3))
        fn, ref_fn, counter = tnff.naf_expand, tnff.naf_expand_ref, tnff.naf_expand
    before = counter.launches
    with torch.no_grad():
        out, again = fn(x, *params), fn(x, *params)
    assert counter.launches == before + 2 and out.dtype == dtype and torch.equal(out, again)
    assert _rel(out.float(), ref_fn(x.float(), *[p.float() for p in params])) <= STANDALONE_TOL[dtype]
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    ref_leaves = [t.clone().requires_grad_() for t in (x, *params)]
    g = torch.randn(rows, c_out, generator=gen).to(cuda, dtype)
    fn(*leaves).backward(g)
    ref_fn(*ref_leaves).backward(g)
    for i, (a, b) in enumerate(zip(leaves, ref_leaves)):  # the same plain VJP on the same inputs
        if b.grad is not None:
            assert _rel(a.grad.float(), b.grad.float()) <= STANDALONE_TOL[dtype], i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,c,length", [(1, 48, 16384), (8, 48, 256), (2, 96, 4096), (3, 176, 300), (2, 40, 37)])
@pytest.mark.parametrize("use_softmax", [False, True])
def test_mdta_attention(cuda, dtype, bh, c, length, use_softmax):
    """K13 against its plain version (in fp32 on the same rounded inputs; 1e-4 in
    fp32, 2e-2 in bf16), twice for equal bits, and the gradients of q, k, v and
    the temperature (in its caller's shape) through MDTAFunction."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(bh, c, length, generator=gen).to(cuda, dtype) for _ in range(3))
    t = (torch.rand(bh, 1, 1, generator=gen) + 0.5).to(cuda, dtype)
    before = tmd.mdta_attention.launches
    with torch.no_grad():
        out, again = tmd.mdta_attention(q, k, v, t, use_softmax), tmd.mdta_attention(q, k, v, t, use_softmax)
    assert tmd.mdta_attention.launches == before + 2 and torch.equal(out, again)
    ref = tmd.mdta_ref(q.float(), k.float(), v.float(), t.float(), use_softmax)
    assert _rel(out.float(), ref) <= {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    leaves = [u.clone().requires_grad_() for u in (q, k, v, t)]
    tmd.mdta_attention(*leaves, use_softmax).backward(out)
    assert leaves[3].grad.shape == (bh, 1, 1)
    ref_leaves = [u.clone().requires_grad_() for u in (q, k, v, t)]
    tmd.mdta_ref(*ref_leaves, use_softmax).backward(out)
    for a, b in zip(leaves, ref_leaves):  # the same plain VJP on the same inputs
        assert _rel(a.grad.float(), b.grad.float()) <= STANDALONE_TOL[dtype]


@pytest.mark.parametrize("arch", ["Restormer", "PromptIR"])
def test_standalone_block_harness_on_the_card(cuda, arch):
    """chip_smoke.py's harness (K14 at every qkv and project_in, K13 at every
    attention) through a tiny net against its K6 route: two K14 and one K13
    launch per TransformerBlock, the output within 1e-4."""
    import chip_smoke

    torch.manual_seed(0)
    kw = dict(dim=16, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1, heads=[1, 2, 2, 4])
    net = (Restormer(**kw) if arch == "Restormer" else PromptIR(**kw)).to(cuda).eval()
    blocks = sum(isinstance(m, TransformerBlock) for m in net.modules())
    x = torch.rand(1, 3, 32, 24, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = (tln_proj.fused_ln_proj.launches, tmd.mdta_attention.launches)
    with torch.inference_mode():
        ref, _ = net(x)
        with mock.patch.object(TransformerBlock, "forward", chip_smoke._standalone_transformer_forward):
            out, _ = net(x)
    assert (tln_proj.fused_ln_proj.launches - before[0], tmd.mdta_attention.launches - before[1]) == (2 * blocks,
                                                                                                       blocks)
    assert _rel(out, ref) <= 1e-4
