"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file imports no JAX, so that it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

(`--noconftest` keeps the JAX setup of tests/conftest.py out). TF32 is off,
so the fp32 plain versions are full fp32.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nemo_tpu_torch.models.asr.configs import conformer_ctc  # noqa: E402
from nemo_tpu_torch.models.asr.ctc_models import EncDecCTCModel  # noqa: E402
from nemo_tpu_torch.models.asr.modules.conformer import RelPositionalEncoding  # noqa: E402
from nemo_tpu_torch.interop.jax_params import model_variables  # noqa: E402
from nemo_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_backward_plain, flash_attention_packed,
    flash_attention_packed_backward_plain, flash_attention_packed_plain, flash_attention_plain,
    flash_dkv, flash_dq, flash_seg_dkv, flash_seg_dq, relpos_flash_attention,
    relpos_flash_attention_backward_plain, relpos_flash_attention_plain, relpos_flash_dkv,
    relpos_flash_dq, row_delta, seg_tile_ranges)
from nemo_tpu_torch.ops.subsampling_kernel import (  # noqa: E402
    fused_subsampling_x4, fused_subsampling_x4_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("b_mn_major", [False, True])
@pytest.mark.parametrize("a_source", ["tma", "registers", "threads"])
def test_wgmma_tile_product_matches_matmul(cuda, n, b_mn_major, a_source):
    """The TMA and wgmma wrappers of csrc/hopper.cuh (the bf16 flash
    kernels'): one warpgroup's m64nNk16 steps over bf16 tiles against
    torch.matmul, a loaded by TMA (as q), as register fragments (as P) or
    stored by the threads in the 128-byte swizzle (as K3's and K4's dS
    band); the bf16 products are exact in fp32, only the fp32 sums' order
    and rounding differ."""
    from nemo_tpu_torch.csrc.loader import wgmma_tile_product

    g = torch.Generator().manual_seed(
        n + 2 * b_mn_major + {"tma": 0, "registers": 1, "threads": 10}[a_source])
    a = torch.randn(64, 64, generator=g).to(cuda, torch.bfloat16)
    b = torch.randn(*((64, n) if b_mn_major else (n, 64)), generator=g).to(cuda, torch.bfloat16)
    c = wgmma_tile_product(a, b, b_mn_major, a_source)
    ref = a.float() @ (b.float() if b_mn_major else b.float().T)
    torch.testing.assert_close(c, ref, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("n,b_layout,a_source", [(256, "mn", "tma"), (256, "mn", "plain"),
                                                  (128, "mn", "plain"), (32, "k_plain", "plain"),
                                                  (96, "mn", "registers")])
def test_wgmma_plain_tile_forms_match_matmul(cuda, n, b_layout, a_source):
    """The wgmma forms of the bf16 fused subsampling (K2): m64n256k16 and
    m64n128k16 with b MN-major by TMA (w2) and a written by the threads with
    no swizzle (the h1 patch, hopper.cuh:desc_plain), and m64n32k16 with
    both operands so (conv1's x patches and w1); and the dh-96 flash
    kernels' m64n96k16, b MN-major over two boxes (the second zero past
    column 96) and a in registers."""
    from nemo_tpu_torch.csrc.loader import wgmma_tile_product

    g = torch.Generator().manual_seed(n + len(b_layout) + len(a_source))
    a = torch.randn(64, 64, generator=g).to(cuda, torch.bfloat16)
    mn = b_layout == "mn"
    b = torch.randn(*((64, n) if mn else (n, 64)), generator=g).to(cuda, torch.bfloat16)
    c = wgmma_tile_product(a, b, mn, a_source, b_plain=b_layout == "k_plain")
    ref = a.float() @ (b.float() if mn else b.float().T)
    torch.testing.assert_close(c, ref, atol=1e-3, rtol=1e-4)


def _attention_inputs(B, H, T, lengths, seed, dh=64):
    g = torch.Generator().manual_seed(seed)
    qu, qv, k, v = (torch.randn(B, T, H, dh, generator=g).transpose(1, 2) for _ in range(4))
    _, pos_emb = RelPositionalEncoding(H * dh)(torch.zeros(1, T, H * dh))
    p = pos_emb @ (torch.randn(H * dh, H * dh, generator=g) / math.sqrt(H * dh))
    return [qu, qv, k, v, p.view(2 * T - 1, H, dh).transpose(0, 1),
            torch.tensor(lengths, dtype=torch.int32), 1.0 / math.sqrt(dh)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,lengths", [(64, [64, 64]), (151, [151, 77]), (200, [1, 133]),
                                       (751, [751, 700]), (100, [100, 37]), (257, [1, 257]),
                                       (129, [129, 1])])
def test_relpos_flash_kernel_matches_plain(cuda, dtype, tol, T, lengths):
    """K1 against its plain version. T under one 128-row query tile (64,
    100: the band's p rows start before row 0 there, and in every last query
    tile where T is no multiple of 128), T = 128 k + 1 (129, 257: a last tile
    of one row), a row of length 1 beside a full one, and the main path's
    T = 751."""
    B, H = len(lengths), 3
    args = [a.to(cuda, dtype) if torch.is_tensor(a) and a.is_floating_point() else
            (a.to(cuda) if torch.is_tensor(a) else a)
            for a in _attention_inputs(B, H, T, lengths, seed=T)]
    launches = relpos_flash_attention.launches
    o, lse = relpos_flash_attention(*args)
    torch.cuda.synchronize()
    assert relpos_flash_attention.launches == launches + 1
    o_ref, lse_ref = relpos_flash_attention_plain(*args)
    assert o.dtype == dtype and o.shape == (B, H, T, 64) and lse.shape == (B, H, T)
    for b, n in enumerate(lengths):  # padded query rows are garbage by design
        torch.testing.assert_close(o[b, :, :n].float(), o_ref[b, :, :n].float(),
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(lse[b, :, :n], lse_ref[b, :, :n], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,lengths", [(64, [64, 64]), (100, [100, 37]), (129, [129, 1]),
                                       (200, [1, 133]), (376, [376, 300]), (376, [376, 376]),
                                       (150, [150, 150]), (320, [320, 190])])
def test_relpos_flash_kernel_matches_plain_dh128(cuda, dtype, tol, T, lengths):
    """K1 at head dim 128 (FastConformer-XL's 1024 over 8 heads) against its
    plain version: T under one 64-row query tile (its band's p rows start
    before row 0), a last tile of one row (129), a row of length 1, and the
    transcription's T' = 376 (30 s at x8), ragged and full. The bf16 block
    owns 128 query rows in two warpgroups of 64: at T = 64 and 129 its second
    warpgroup's rows lie wholly past T, at 150 the first's are partly valid,
    and 320 is an odd number of 64-row tiles (the last item's second
    warpgroup past T, beside a ragged row)."""
    B, H = len(lengths), 2
    args = [a.to(cuda, dtype) if torch.is_tensor(a) and a.is_floating_point() else
            (a.to(cuda) if torch.is_tensor(a) else a)
            for a in _attention_inputs(B, H, T, lengths, seed=T + 5, dh=128)]
    launches = relpos_flash_attention.launches
    o, lse = relpos_flash_attention(*args)
    torch.cuda.synchronize()
    assert relpos_flash_attention.launches == launches + 1
    o_ref, lse_ref = relpos_flash_attention_plain(*args)
    assert o.dtype == dtype and o.shape == (B, H, T, 128) and lse.shape == (B, H, T)
    for b, n in enumerate(lengths):  # padded query rows are garbage by design
        torch.testing.assert_close(o[b, :, :n].float(), o_ref[b, :, :n].float(),
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(lse[b, :, :n], lse_ref[b, :, :n], atol=1e-4, rtol=1e-5)


def _subsampling_inputs(B, T, F, C, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, T, F, generator=g), torch.randn(3, 3, 1, C, generator=g) / 3,
            0.1 * torch.randn(C, generator=g),
            torch.randn(3, 3, C, C, generator=g) / math.sqrt(9 * C),
            0.1 * torch.randn(C, generator=g)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,F,C", [(2, 99, 80, 128), (1, 130, 81, 256), (3, 64, 40, 128),
                                     (1, 3001, 80, 512), (2, 50, 4, 128), (1, 40, 160, 256),
                                     (1, 33, 80, 384)])
def test_fused_subsampling_kernel_matches_plain(cuda, dtype, tol, B, T, F, C):
    """K2 against its plain version. Output positions no multiple of a
    block's (T4 F4 = 500, 726 at 6 and 5 output rows a block), F = 81 (F4 =
    21, odd), F4 = 1 (F = 4), F4 = 40 (column groups of 31), C = 128 and 384
    (tiles of 128 output channels), and the main path's shape."""
    args = [a.to(cuda, dtype) for a in _subsampling_inputs(B, T, F, C, seed=T)]
    launches = fused_subsampling_x4.launches
    out = fused_subsampling_x4(*args)
    torch.cuda.synchronize()
    assert fused_subsampling_x4.launches == launches + 1
    ref = fused_subsampling_x4_plain(*args)
    assert out.shape == ref.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    args = [a.to(cuda) if torch.is_tensor(a) else a
            for a in _attention_inputs(1, 2, 16, [16], seed=0)]
    with pytest.raises(ValueError, match="dtype"):
        relpos_flash_attention(*[a.half() if torch.is_tensor(a) and a.is_floating_point()
                                 else a for a in args])
    sub = [a.to(cuda) for a in _subsampling_inputs(1, 20, 16, 64, seed=0)]
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_subsampling_x4(*sub)


def test_small_model_on_cuda_matches_cpu(cuda):
    """A 2-layer model (d_model 128, 2 heads of 64) with both kernel flags, fp32:
    the card (kernels) against the CPU (plain versions), same seeded weights."""
    cfg = conformer_ctc("large", att_impl="decomposed_flash", fused_subsampling=True)
    cfg.encoder.update(n_layers=2, d_model=128, n_heads=2)
    cfg.decoder.feat_in = 128
    x = (0.1 * np.random.RandomState(0).randn(2, 32000)).astype(np.float32)
    lens = torch.tensor([32000, 20000], dtype=torch.int32)
    out = {}
    for device in ("cuda", "cpu"):
        model = EncDecCTCModel(cfg, device=device, seed=3)
        k1, k2 = relpos_flash_attention.launches, fused_subsampling_x4.launches
        lp, n = model(torch.from_numpy(x).to(device), lens.to(device))
        out[device] = (lp.cpu(), n.cpu(), relpos_flash_attention.launches - k1,
                       fused_subsampling_x4.launches - k2)
    (lp, n, l1, l2), (ref, ref_n, r1, r2) = out["cuda"], out["cpu"]
    assert (l1, l2, r1, r2) == (2, 1, 0, 0)
    assert torch.equal(n, ref_n)
    for b, t in enumerate(n.tolist()):
        torch.testing.assert_close(lp[b, :t], ref[b, :t], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("T,lengths,H", [(64, [64, 64], 3), (151, [151, 77], 3),
                                         (200, [1, 133], 3), (751, [751, 700], 3),
                                         (128, [128, 128], 3), (129, [129, 65], 3),
                                         (1000, [1000, 1], 3), (200, [200, 70], 1),
                                         (25, [25, 10], 3)])
def test_relpos_flash_backward_kernels_match_plain(cuda, dtype, tol, T, lengths, H):
    """K3 (dqu, dqv) and K4 (dk, dv, dp) against the plain backward, each
    within tol of its max-abs value: fp32 differs by the order of sums (dp
    is summed across blocks in an order that changes from run to run); bf16
    also by the kernels' rounding of P and dS to bf16 before each product.
    The shapes meet the bf16 kernels' tiling: 128-row blocks whole (128),
    with one row (129) or one warpgroup (200) past T, p's band past both of
    its ends, a block of keys wholly past a length of 1 (1000), one head, and
    a clip shorter than one tile (25 frames, 1 s)."""
    B = len(lengths)
    args = [a.to(cuda, dtype) if torch.is_tensor(a) and a.is_floating_point() else
            (a.to(cuda) if torch.is_tensor(a) else a)
            for a in _attention_inputs(B, H, T, lengths, seed=T + 1)]
    o, lse = relpos_flash_attention(*args)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(T)).to(cuda, dtype)
    delta = row_delta(o, do)
    launches = relpos_flash_dq.launches, relpos_flash_dkv.launches
    out = (*relpos_flash_dq(*args, lse, delta, do), *relpos_flash_dkv(*args, lse, delta, do))
    torch.cuda.synchronize()
    assert (relpos_flash_dq.launches, relpos_flash_dkv.launches) == (launches[0] + 1,
                                                                     launches[1] + 1)
    ref = relpos_flash_attention_backward_plain(*args, o, lse, do)
    for name, x, r in zip(("dqu", "dqv", "dk", "dv", "dp"), out, ref):
        assert x.shape == r.shape and x.dtype == dtype, name
        r = r.float()
        torch.testing.assert_close(x.float(), r, atol=tol * float(r.abs().max()), rtol=0,
                                   msg=name)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("T,lengths,H", [(64, [64, 64], 2), (129, [129, 65], 2),
                                         (200, [1, 133], 2), (376, [376, 300], 2),
                                         (376, [376, 376], 1), (25, [25, 10], 2),
                                         (65, [65, 65], 2), (130, [130, 3], 2),
                                         (376, [376, 376, 376, 376], 8),
                                         (376, [321, 376], 2)])
def test_relpos_flash_backward_kernels_match_plain_dh128(cuda, dtype, tol, T, lengths, H):
    """K3 and K4 at head dim 128 against the plain backward, each gradient
    within tol of its max-abs value (as the dh-64 test above): whole 64-row
    tiles (64), one row past them (129, 65: a last query tile and a last key
    item of one row), p's band past both of its ends and a row of length 1
    (200), the calibration's T' = 376 (30 s at x8), ragged and full, a clip
    shorter than one tile, a length of 3 (130), whose first key item holds
    61 keys past the length and whose others hold none before it, the
    calibration's whole B=4 x H=8 (192 items of 64 rows or keys: the
    persistent grid takes a second round on 132 SMs), and a length that ends
    one row into a key tile (321). The bf16 K3 and K4 split an item between
    two warpgroups by output (K3: the band chunk, s and P; dP, dS, dqu and
    dqv. K4: P^T and dv; dS^T, dk and dp), so every row or key passes
    through both."""
    B = len(lengths)
    args = [a.to(cuda, dtype) if torch.is_tensor(a) and a.is_floating_point() else
            (a.to(cuda) if torch.is_tensor(a) else a)
            for a in _attention_inputs(B, H, T, lengths, seed=T + 7, dh=128)]
    o, lse = relpos_flash_attention(*args)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(T)).to(cuda, dtype)
    delta = row_delta(o, do)
    launches = relpos_flash_dq.launches, relpos_flash_dkv.launches
    out = (*relpos_flash_dq(*args, lse, delta, do), *relpos_flash_dkv(*args, lse, delta, do))
    torch.cuda.synchronize()
    assert (relpos_flash_dq.launches, relpos_flash_dkv.launches) == (launches[0] + 1,
                                                                     launches[1] + 1)
    ref = relpos_flash_attention_backward_plain(*args, o, lse, do)
    for name, x, r in zip(("dqu", "dqv", "dk", "dv", "dp"), out, ref):
        assert x.shape == r.shape and x.dtype == dtype, name
        r = r.float()
        torch.testing.assert_close(x.float(), r, atol=tol * float(r.abs().max()), rtol=0,
                                   msg=name)


@pytest.mark.parametrize("lengths", [[376, 376, 376, 376], [376, 300, 321, 65]])
def test_relpos_flash_dq_dh128_is_repeatable(cuda, lengths):
    """Two launches of the bf16 K3 at dh 128 give bitwise-equal dqu and dqv:
    each item's sums run in one block, in a fixed order, with no atomics. At
    the calibration's B=4 x H=8 x T'=376, where the persistent grid takes a
    second round, full and ragged."""
    args = [a.to(cuda, torch.bfloat16) if torch.is_tensor(a) and a.is_floating_point() else
            (a.to(cuda) if torch.is_tensor(a) else a)
            for a in _attention_inputs(4, 8, 376, lengths, seed=sum(lengths), dh=128)]
    o, lse = relpos_flash_attention(*args)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(3)).to(cuda, torch.bfloat16)
    delta = row_delta(o, do)
    first = relpos_flash_dq(*args, lse, delta, do)
    second = relpos_flash_dq(*args, lse, delta, do)
    torch.cuda.synchronize()
    for name, x, y in zip(("dqu", "dqv"), first, second):
        assert torch.isfinite(x).all() and torch.equal(x, y), name


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_relpos_kernel_launch_shapes(cuda, kernel, head_dim):
    """The launch shape of the bf16 K1, K3 and K4: 384 threads, two consumer
    warpgroups, no cluster, within the 227 KB of shared memory a block can
    have, and no local memory (a spill) at dh 128, where the blocks hold q,
    dO, or k and v, as register fragments."""
    from nemo_tpu_torch.ops.flash_attention import relpos_kernel_shape

    shape = relpos_kernel_shape(kernel, head_dim)
    assert (shape["threads"], shape["warpgroups"], shape["cluster"]) == (384, 2, 1)
    assert 0 < shape["shared_bytes"] <= 232448 and shape["registers"] > 0
    if head_dim == 128:
        assert shape["local_bytes"] == 0


def test_attention_output_is_differentiable_on_cuda(cuda):
    """K1's output carries the autograd Function, and its backward launches
    K3 and K4 once each."""
    args = [a.to(cuda).requires_grad_() if torch.is_tensor(a) and a.is_floating_point() else
            (a.to(cuda) if torch.is_tensor(a) else a)
            for a in _attention_inputs(2, 2, 80, [80, 50], seed=1)]
    o, _ = relpos_flash_attention(*args)
    assert type(o.grad_fn.next_functions[0][0]).__name__ == "RelposFlashAttentionBackward"
    launches = relpos_flash_dq.launches, relpos_flash_dkv.launches
    grads = torch.autograd.grad(o[:, :, :50].sum(), [a for a in args[:5]])
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    assert (relpos_flash_dq.launches, relpos_flash_dkv.launches) == (launches[0] + 1,
                                                                     launches[1] + 1)


def test_fused_subsampling_raises_under_grad_on_cuda(cuda):
    sub = [a.to(cuda) for a in _subsampling_inputs(1, 40, 16, 128, seed=0)]
    sub[3].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_subsampling_x4(*sub)
    with torch.no_grad():
        fused_subsampling_x4(*sub)


def test_small_model_gradients_on_cuda_match_cpu(cuda):
    """The calibration loss of a 2-layer model (d_model 128, 2 heads of 64,
    both kernel flags, fp32) on the same mel features: the gradient of every
    variable on the card (K1, K3, K4; the conv pair) against the CPU (plain
    versions), within 1e-4 of each leaf's max-abs value plus 1e-6.

    cuDNN and the CPU conv sum in another order, so the conv pair's
    pre-ReLU outputs differ by ~3e-6; a value that close to 0 can open its
    ReLU gate on one device and not on the other, which moves both convs'
    weight gradients by ~1 % of their max (one such value of 261,120 did, on
    an H100). The CPU run therefore takes the card's gate where the two
    pre-activations straddle 0 within 1e-5 of it; a gate that differs
    anywhere else fails."""
    cfg = conformer_ctc("large", att_impl="decomposed_flash", fused_subsampling=True)
    cfg.encoder.update(n_layers=2, d_model=128, n_heads=2)
    cfg.decoder.feat_in = 128
    rng = np.random.RandomState(0)
    x = torch.from_numpy((0.1 * rng.randn(2, 32000)).astype(np.float32))
    lens = torch.tensor([32000, 25000], dtype=torch.int32)
    labels = torch.from_numpy(rng.randint(0, 29, (2, 50)))
    models = {device: EncDecCTCModel(cfg, device=device, seed=3) for device in ("cpu", "cuda")}
    with torch.no_grad():  # one frontend for both: its last bits flip ReLU gates of conv0
        feats = models["cpu"].mel_features(x, lens)
    card_pre = {}

    def gate_hook(i, device):
        def hook(module, args, out):
            if device == "cuda":
                card_pre[i] = out.detach().cpu()
                return None
            card = card_pre[i]
            flip = (card > 0) != (out.detach() > 0)
            assert bool((out.detach()[flip].abs() < 1e-5).all()), f"conv{i}: a gate differs"
            return out + torch.where(flip, card - out.detach(), torch.zeros_like(card))
        return hook

    grads = {}
    for device in ("cuda", "cpu"):
        model = models[device]
        for i in (0, 1):
            getattr(model.encoder.pre_encode, f"conv{i}").register_forward_hook(
                gate_hook(i, device))
        leaves = model_variables(model)
        for t in leaves.values():
            t.requires_grad_(True)
        enc, _ = model.encoder(*(f.to(device) for f in feats), conv_pair_subsampling=True)
        lp = model.decoder(enc)[:, :labels.shape[1]]
        loss = -lp.gather(-1, labels.to(device)[..., None])[..., 0].mean()
        grads[device] = dict(zip(leaves, (g.cpu() for g in torch.autograd.grad(
            loss, list(leaves.values())))))
    for name, ref in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][name], ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()) + 1e-6, msg=name)


# causal GQA flash attention: K5 (forward), K6 (dq), K7 (dk, dv)
def _assert_rows_close(x, r, tol, norm_tol, msg):
    """Each row (the last axis: one query's o or dq, one key's dk or dv) at
    its own scale, since causal rows and keys shrink along the sequence:
    |x - r| <= tol * max|r| over the row + tol / 100 * max|r|, and ||x - r|| <=
    norm_tol * ||r||."""
    x, r = x.float(), r.float()
    limit = tol * r.abs().amax(-1, keepdim=True) + tol / 100 * float(r.abs().max())
    worst = float(((x - r).abs() / limit).max())
    rel = float(torch.linalg.vector_norm(x - r) / torch.linalg.vector_norm(r))
    assert worst <= 1 and rel <= norm_tol, f"{msg}: worst row {worst:.3f}, rel norm {rel:.2e}"


GQA_CASES = [  # H, G, T, dh, causal, window
    (4, 1, 256, 64, True, None), (4, 2, 200, 64, True, 48), (4, 4, 192, 128, True, None),
    (4, 2, 128, 128, False, None), (8, 2, 320, 64, False, 100), (4, 4, 256, 64, True, 64),
    # the bf16 forward's 128-row blocks and 128-key (dh 64) or 64-key (dh 128) tiles:
    # less than a tile, a 64-row half, 1.5 blocks, one row short of and one row past
    # a multiple of 128; 8 query heads a kv head, a window at dh 128, not causal (one
    # row: test_flash_forward_of_one_row_matches_plain)
    (8, 1, 17, 64, True, None), (4, 2, 64, 64, True, None), (8, 1, 192, 128, True, 100),
    (4, 1, 2047, 64, True, None), (4, 2, 2049, 128, False, None),
    # a multiple of 64 that is not one of 128: the bf16 dk/dv's last 128-key block
    # ends 64 keys past T
    (4, 2, 1984, 64, True, None),
    # dh 96 (Phi-3-mini), in dh 128's tiles with a zero tail: G = H, G < H with a
    # window, less than a tile, one row past a multiple of 128 and not causal
    (4, 4, 256, 96, True, None), (4, 2, 200, 96, True, 48), (8, 2, 17, 96, True, None),
    (4, 1, 2049, 96, False, None)]


@pytest.mark.parametrize("dtype,tol,gtol,ntol", [(torch.float32, 2e-5, 1e-4, 1e-5),
                                                 (torch.bfloat16, 2e-2, 3e-2, 1e-2)])
@pytest.mark.parametrize("H,G,T,dh,causal,window", GQA_CASES)
def test_flash_kernels_match_plain(cuda, dtype, tol, gtol, H, G, T, dh, causal, window, ntol):
    """K5 against the plain forward (o within tol, and row by row; lse
    within 1e-4), and K6, K7 against the plain backward, each gradient within
    gtol of each row's max-abs value and within ntol in relative norm: at
    G < H and G = H, dh 64, 96 and 128, with and without a window, causal or
    not, and T not a multiple of the 64-row tile."""
    B, scale = 2, 1.0 / math.sqrt(dh)
    g = torch.Generator().manual_seed(T + dh)
    q, do = (torch.randn(B, T, H, dh, generator=g).to(cuda, dtype).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn(B, T, G, dh, generator=g).to(cuda, dtype).transpose(1, 2)
            for _ in range(2))
    launches = flash_attention.launches, flash_dq.launches, flash_dkv.launches
    o = flash_attention(q, k, v, scale, causal, window)
    o_ref, lse = flash_attention_plain(q, k, v, scale, causal, window)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    _assert_rows_close(o, o_ref, tol, ntol, "o")
    from nemo_tpu_torch.ops.flash_attention import _k5_launch
    _, lse_k = _k5_launch(q, k, v, scale, causal, window)
    torch.testing.assert_close(lse_k, lse, atol=1e-4, rtol=1e-5)
    delta = row_delta(o, do)
    args = (q, k, v, scale, causal, window, lse_k, delta, do)
    out = (flash_dq(*args), *flash_dkv(*args))
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_dq.launches, flash_dkv.launches) == (
        launches[0] + 2, launches[1] + 1, launches[2] + 1)
    ref = flash_attention_backward_plain(q, k, v, scale, causal, window, o, lse_k, do)
    for name, x, r in zip(("dq", "dk", "dv"), out, ref):
        assert x.shape == r.shape and x.dtype == dtype, name
        _assert_rows_close(x, r, gtol, ntol, name)


@pytest.mark.parametrize("dtype,tol,ntol", [(torch.float32, 2e-5, 1e-5),
                                          (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("dh", [64, 96, 128])
def test_flash_forward_of_one_row_matches_plain(cuda, dtype, tol, ntol, dh):
    """K5 at T = 1 (one row in a block of 128, one key in a tile), 8 query
    heads a kv head: o and lse against the plain forward. The gradients are
    not compared here: with one key a row dq and dk are 0 in exact
    arithmetic, and both sides give rounding noise."""
    from nemo_tpu_torch.ops.flash_attention import _k5_launch

    g = torch.Generator().manual_seed(dh)
    q = torch.randn(3, 1, 8, dh, generator=g).to(cuda, dtype).transpose(1, 2)
    k, v = (torch.randn(3, 1, 1, dh, generator=g).to(cuda, dtype).transpose(1, 2)
            for _ in range(2))
    o, lse = _k5_launch(q, k, v, 1.0 / math.sqrt(dh), True, None)
    o_ref, lse_ref = flash_attention_plain(q, k, v, 1.0 / math.sqrt(dh), True, None)
    torch.testing.assert_close(o.transpose(1, 2).float(), o_ref.float(), atol=tol, rtol=tol)
    _assert_rows_close(o.transpose(1, 2), o_ref, tol, ntol, "o")
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


def test_flash_output_is_differentiable_on_cuda(cuda):
    """K5's output carries the autograd Function, and its backward launches
    K6 and K7 once each."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 128, 64, generator=g).to(cuda).requires_grad_()
    k, v = (torch.randn(2, 2, 128, 64, generator=g).to(cuda).requires_grad_() for _ in range(2))
    o = flash_attention(q, k, v, 0.125)
    assert type(o.grad_fn.next_functions[0][0]).__name__ == "FlashAttentionBackward"
    launches = flash_dq.launches, flash_dkv.launches
    grads = torch.autograd.grad(o.square().sum(), (q, k, v))
    assert all(torch.isfinite(x).all() and x.abs().sum() > 0 for x in grads)
    assert (flash_dq.launches, flash_dkv.launches) == (launches[0] + 1, launches[1] + 1)


def test_llm_train_step_launch_counts(cuda):
    """One train step of a tiny Llama-style model (2 layers, 8 heads of 64
    over 2 kv heads, bf16, flash backend, full remat) on the card: K5
    launches twice a layer (forward and recompute), K6 and K7 once; the
    loss and grad norm are finite."""
    from nemo_tpu_torch.models.llm.config import tiny_test
    from nemo_tpu_torch.models.llm.train import GPTTrainModule

    cfg = tiny_test(hidden_size=512, num_attention_heads=8, num_query_groups=2, seq_length=256,
                    compute_dtype="bfloat16", attention_backend="flash", remat="full",
                    share_embeddings_and_output_weights=True, rope_scaling="llama3")
    mod = GPTTrainModule(cfg, device=cuda, seed=0)
    rng = np.random.RandomState(0)
    batch = {k: rng.randint(0, cfg.vocab_size, (2, 256)) for k in ("tokens", "labels")}
    launches = flash_attention.launches, flash_dq.launches, flash_dkv.launches
    m = mod.train_step(batch)
    torch.cuda.synchronize()
    got = (flash_attention.launches - launches[0], flash_dq.launches - launches[1],
           flash_dkv.launches - launches[2])
    assert got == (2 * cfg.num_layers, cfg.num_layers, cfg.num_layers)
    assert math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))


# packed rows: K8 (forward), K9 (dq), K10 (dk, dv)
def packed_segments(layout: str, T: int) -> torch.Tensor:
    """[2, T] int32 segment ids: "packed", two rows of `pack_batch` over
    lengths of the SFT data (a prompt of 64-1024 tokens and an answer of
    8-128, and one eos); "mixed", a row with ids 1, 2, 1, 3 and a run of
    padding in the middle and at the end, then a row of padding only;
    "one", one segment over each whole row; "mid_tile", segments that start
    inside the bf16 forward's 128-row tiles (at 100, 300, 1000 and 70), with
    padding inside (230-299) and at the end of the first row."""
    from nemo_tpu_torch.data.packed_sequence import pack_batch

    seg = torch.zeros(2, T, dtype=torch.int32)
    if layout == "packed":
        rng = np.random.RandomState(T)
        lengths = rng.randint(64, 1025, 40) + rng.randint(8, 129, 40) + 1
        seqs = [np.zeros(n, np.int32) for n in lengths]
        rows = pack_batch(seqs, seqs, [np.ones(n, np.float32) for n in lengths], T)
        seg = torch.from_numpy(rows["segment_ids"][:2].copy())
    elif layout == "mixed":
        cuts = [0, 3 * T // 20, 7 * T // 20, 9 * T // 20, 13 * T // 20, 19 * T // 20 - 5]
        for sid, (lo, hi) in zip((1, 2, 0, 1, 3), zip(cuts, cuts[1:])):
            seg[0, lo:hi] = sid
    elif layout == "mid_tile":
        for sid, lo, hi in ((1, 0, 100), (2, 100, 230), (3, 300, 1000), (4, 1000, T - 58)):
            seg[0, lo:hi] = sid
        seg[1, :70], seg[1, 70:] = 1, 2
    else:
        seg[:] = 1
    return seg


PACKED_CASES = [(32, 8, 64, None), (32, 8, 64, 512), (12, 12, 128, None),  # H, G, dh, window
                (32, 32, 96, None)]


@pytest.mark.parametrize("dtype,tol,gtol,ntol", [(torch.float32, 2e-5, 1e-4, 1e-5),
                                                 (torch.bfloat16, 2e-2, 3e-2, 1e-2)])
@pytest.mark.parametrize("H,G,dh,window", PACKED_CASES)
@pytest.mark.parametrize("layout", ["packed", "mixed", "one", "mid_tile"])
def test_packed_flash_kernels_match_plain(cuda, layout, H, G, dh, window, dtype, tol, gtol, ntol):
    """K8 against the plain packed forward and K9, K10 against the plain
    packed backward at B=2, S=2048, held row by row as K5-K7 are: padding
    rows give exactly 0 in o and dq, padding keys exactly 0 in dk and dv;
    with one segment per row K8, K9 and K10 give K5's, K6's and K7's bits."""
    B, T, scale = 2, 2048, 1.0 / math.sqrt(dh)
    g = torch.Generator().manual_seed(dh + (window or 0))
    q, do = (torch.randn(B, T, H, dh, generator=g).to(cuda, dtype).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn(B, T, G, dh, generator=g).to(cuda, dtype).transpose(1, 2)
            for _ in range(2))
    seg = packed_segments(layout, T).to(cuda)
    launches = flash_attention_packed.launches, flash_seg_dq.launches, flash_seg_dkv.launches
    o = flash_attention_packed(q, k, v, seg, scale, True, window)
    o_ref, lse_ref = flash_attention_packed_plain(q, k, v, seg, scale, True, window)
    _assert_rows_close(o, o_ref, tol, ntol, "o")
    from nemo_tpu_torch.ops.flash_attention import _k8_launch
    _, lse = _k8_launch(q, k, v, seg, seg_tile_ranges(seg), scale, True, window)
    pad = seg == 0  # [B, T]
    live = ~pad[:, None, :].expand(B, H, T)
    torch.testing.assert_close(lse[live], lse_ref[live], atol=1e-4, rtol=1e-5)
    assert bool((lse[~live] == -1e30).all()) and bool((o.transpose(1, 2)[pad] == 0).all())
    args = (q, k, v, seg, scale, True, window, lse, row_delta(o, do), do)
    out = (flash_seg_dq(*args), *flash_seg_dkv(*args))
    torch.cuda.synchronize()
    assert (flash_attention_packed.launches, flash_seg_dq.launches, flash_seg_dkv.launches) == (
        launches[0] + 2, launches[1] + 1, launches[2] + 1)
    ref = flash_attention_packed_backward_plain(q, k, v, seg, scale, True, window, o, lse, do)
    for name, x, r in zip(("dq", "dk", "dv"), out, ref):
        assert x.shape == r.shape and x.dtype == dtype, name
        _assert_rows_close(x, r, gtol, ntol, name)
        assert bool((x.transpose(1, 2)[pad] == 0).all()), f"{name}: padding is not exactly 0"
    if layout == "one":  # the same kernels as K5-K7, bit for bit
        from nemo_tpu_torch.ops.flash_attention import _k5_launch
        o5, lse5 = _k5_launch(q, k, v, scale, True, window)
        assert torch.equal(o.transpose(1, 2), o5) and torch.equal(lse, lse5)
        args5 = (q, k, v, scale, True, window, lse5, row_delta(o, do), do)
        for name, x, y in zip(("dq", "dk", "dv"), out, (flash_dq(*args5), *flash_dkv(*args5))):
            assert torch.equal(x, y), name


def test_packed_flash_output_is_differentiable_on_cuda(cuda):
    """K8's output carries the autograd Function, and its backward launches
    K9 and K10 once each."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 256, 64, generator=g).to(cuda).requires_grad_()
    k, v = (torch.randn(2, 2, 256, 64, generator=g).to(cuda).requires_grad_() for _ in range(2))
    seg = packed_segments("mixed", 256).to(cuda)
    o = flash_attention_packed(q, k, v, seg, 0.125)
    assert type(o.grad_fn.next_functions[0][0]).__name__ == "FlashAttentionPackedBackward"
    launches = flash_seg_dq.launches, flash_seg_dkv.launches
    grads = torch.autograd.grad(o.square().sum(), (q, k, v))
    assert all(torch.isfinite(x).all() and x.abs().sum() > 0 for x in grads)
    assert (flash_seg_dq.launches, flash_seg_dkv.launches) == (launches[0] + 1, launches[1] + 1)


def _packed_llm_batch(B, S, vocab, seed):
    """A packed batch of random tokens: segments from `packed_segments`'s
    "packed" rows cut to S, positions from 0 in each segment, loss on the
    second half of each segment."""
    from nemo_tpu_torch.data.packed_sequence import pack_batch

    rng = np.random.RandomState(seed)
    lengths = rng.randint(S // 8, S // 2, 6 * B)
    seqs = [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]
    masks = [np.r_[np.zeros(n // 2), np.ones(n - n // 2)].astype(np.float32) for n in lengths]
    rows = pack_batch(seqs, [rng.randint(0, vocab, n).astype(np.int32) for n in lengths], masks,
                      S)
    return {key: torch.from_numpy(val[:B].copy()) for key, val in rows.items()}


def test_packed_llm_gradients_on_cuda_match_cpu(cuda):
    """The packed SFT loss of a 2-layer model at Llama-3.2-1B's width (32
    heads over 8, hidden 2048, FFN 8192, llama3 RoPE; the vocab cut to 8192),
    fp32, B=2 x S=256, flash backend and full remat: on the card (K8-K10)
    against the CPU (plain versions), the loss within 1e-5 relative and every
    gradient within 1e-4 of its leaf's max-abs plus 1e-6."""
    from nemo_tpu_torch.models.llm.config import llama32_1b
    from nemo_tpu_torch.models.llm.train import GPTTrainModule

    cfg = llama32_1b(num_layers=2, vocab_size=8192, seq_length=256, compute_dtype="float32",
                     attention_backend="flash", remat="full")
    batch = _packed_llm_batch(2, 256, cfg.vocab_size, seed=5)
    cpu = GPTTrainModule(cfg, device="cpu", seed=0)
    card = GPTTrainModule(cfg, device=cuda, seed=0)
    card.model.load_state_dict(cpu.model.state_dict())
    launches = flash_attention_packed.launches, flash_seg_dq.launches, flash_seg_dkv.launches
    out = {}
    for name, mod in (("cpu", cpu), ("cuda", card)):
        b = {key: val.to(mod.device) for key, val in batch.items()}
        loss = mod.loss(b["tokens"], b["labels"], b["loss_mask"], positions=b["positions"],
                        segment_ids=b["segment_ids"])
        grads = torch.autograd.grad(loss, mod.params)
        out[name] = (float(loss.detach()), [x.cpu() for x in grads])
    assert (flash_attention_packed.launches - launches[0], flash_seg_dq.launches - launches[1],
            flash_seg_dkv.launches - launches[2]) == (4, 2, 2)
    (loss, grads), (ref_loss, ref_grads) = out["cuda"], out["cpu"]
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for (name, _), x, r in zip(cpu.model.named_parameters(), grads, ref_grads):
        torch.testing.assert_close(x, r, rtol=0, atol=1e-4 * float(r.abs().max()) + 1e-6,
                                   msg=name)


def test_packed_llm_train_step_launch_counts(cuda, monkeypatch):
    """One packed train step of a tiny Llama-style model (2 layers, 8 heads
    of 64 over 2 kv heads, bf16, flash, full remat) on the card: K8 launches
    twice a layer, K9 and K10 once, K5-K7 never; the segments' tile ranges
    are computed once for the step; the loss is finite."""
    from nemo_tpu_torch.models.llm import gpt
    from nemo_tpu_torch.models.llm.config import tiny_test
    from nemo_tpu_torch.models.llm.train import GPTTrainModule

    calls = []
    monkeypatch.setattr(gpt, "seg_tile_ranges",
                        lambda seg: calls.append(seg) or seg_tile_ranges(seg))

    cfg = tiny_test(hidden_size=512, num_attention_heads=8, num_query_groups=2, seq_length=256,
                    compute_dtype="bfloat16", attention_backend="flash", remat="full",
                    share_embeddings_and_output_weights=True, rope_scaling="llama3")
    mod = GPTTrainModule(cfg, device=cuda, seed=0)
    batch = _packed_llm_batch(2, 256, cfg.vocab_size, seed=1)
    counters = (flash_attention_packed, flash_seg_dq, flash_seg_dkv, flash_attention, flash_dq,
                flash_dkv)
    launches = [fn.launches for fn in counters]
    m = mod.train_step(batch)
    torch.cuda.synchronize()
    got = tuple(fn.launches - n for fn, n in zip(counters, launches))
    L = cfg.num_layers
    assert got == (2 * L, L, L, 0, 0, 0)
    assert len(calls) == 1
    assert math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))


# explicit positions: K11 (forward), K12 (dq), K13 (dk, dv), and the ring
def _zigzag_positions(S: int, cp: int) -> torch.Tensor:
    from nemo_tpu_torch.ops.ring_attention import zigzag_order

    return torch.from_numpy(zigzag_order(S, cp).astype(np.int32))


def position_layout(layout: str, Tl: int):
    """(qpos, kpos, window, q_offset) of one ring step at Tl rows a rank:
    "arange" (0 .. Tl-1 on both sides), "diagonal" (rank 0 of the zig-zag
    cp 2 layout against itself), "off_diagonal" (rank 0's rows against rank
    1's keys: the rows of chunk 0 keep no key), "window" (the diagonal with
    a window of Tl / 4), "offset" (Tl / 2 rows after Tl / 2 keys)."""
    if layout in ("arange", "offset"):
        pos = torch.arange(Tl, dtype=torch.int32)
        return (pos[Tl // 2:], pos, None, Tl // 2) if layout == "offset" else (pos, pos, None, 0)
    z = _zigzag_positions(2 * Tl, 2)
    qpos, kpos = z[:Tl], (z[Tl:] if layout == "off_diagonal" else z[:Tl])
    return qpos, kpos, (Tl // 4 if layout == "window" else None), 0


@pytest.mark.parametrize("dtype,tol,gtol,ntol", [(torch.float32, 2e-5, 1e-4, 1e-5),
                                                 (torch.bfloat16, 2e-2, 3e-2, 1e-2)])
@pytest.mark.parametrize("H,G,dh", [(32, 8, 64), (12, 12, 128), (32, 32, 96)])
@pytest.mark.parametrize("layout", ["arange", "diagonal", "off_diagonal", "window", "offset",
                                    "arange_192", "off_diagonal_192"])
def test_positions_flash_kernels_match_plain(cuda, layout, H, G, dh, dtype, tol, gtol, ntol):
    """K11 against the plain positions forward, and K12, K13 against the
    plain backward given a nonzero lse cotangent, at B=2 and 512 rows a rank
    (192 for the "_192" layouts: a multiple of 64 that is not one of the bf16
    forward's 128-row blocks), held row by row as K5-K7 are: rows that keep no
    key give o = 0, lse = -1e30 and dq = 0 exactly; at "arange" K11-K13 give
    K5-K7's bits."""
    from nemo_tpu_torch.ops.flash_attention import (
        _k11_launch, _k5_launch, flash_attention_positions,
        flash_attention_positions_backward_plain, flash_attention_positions_plain,
        flash_pos_dkv, flash_pos_dq, pos_delta)

    B, Tl, scale = 2, 192 if layout.endswith("_192") else 512, 1.0 / math.sqrt(dh)
    qpos, kpos, window, _ = position_layout(layout.removesuffix("_192"), Tl)
    qpos, kpos = qpos.to(cuda), kpos.to(cuda)
    g = torch.Generator().manual_seed(dh + len(layout))
    q, do = (torch.randn(B, len(qpos), H, dh, generator=g).to(cuda, dtype).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn(B, len(kpos), G, dh, generator=g).to(cuda, dtype).transpose(1, 2)
            for _ in range(2))
    dlse = torch.randn(B, H, len(qpos), generator=g).to(cuda)
    o, lse_w = flash_attention_positions(q, k, v, qpos, kpos, scale, True, window)
    _, lse = _k11_launch(q, k, v, qpos, kpos, scale, True, window)
    o_ref, lse_ref = flash_attention_positions_plain(q, k, v, qpos, kpos, scale, True, window)
    dead = (kpos[None, :] > qpos[:, None]).all(-1)
    assert bool(dead.any()) == layout.startswith("off_diagonal")
    _assert_rows_close(o, o_ref, tol, ntol, "o")
    assert torch.equal(lse, lse_w)
    torch.testing.assert_close(lse[:, :, ~dead], lse_ref[:, :, ~dead], atol=1e-3, rtol=1e-4)
    assert bool((o[:, :, dead] == 0).all()) and bool((lse[:, :, dead] == -1e30).all())
    args = (q, k, v, qpos, kpos, scale, True, window, lse, pos_delta(o, do, dlse), do)
    out = (flash_pos_dq(*args), *flash_pos_dkv(*args))
    ref = flash_attention_positions_backward_plain(q, k, v, qpos, kpos, scale, True, window, o,
                                                   lse, do, dlse)
    torch.cuda.synchronize()
    for name, x, r in zip(("dq", "dk", "dv"), out, ref):
        assert x.shape == r.shape and x.dtype == dtype, name
        _assert_rows_close(x, r, gtol, ntol, name)
    assert bool((out[0][:, :, dead] == 0).all())
    if layout.startswith("arange"):  # K5-K7 step for step
        o5, lse5 = _k5_launch(q, k, v, scale, True, window)
        args5 = (q, k, v, scale, True, window, lse5, pos_delta(o, do, dlse), do)
        assert torch.equal(o.transpose(1, 2), o5) and torch.equal(lse, lse5)
        for x, y in zip(out, (flash_dq(*args5), *flash_dkv(*args5))):
            assert torch.equal(x, y)


def test_positions_flash_is_differentiable_through_lse_on_cuda(cuda):
    """flash_attention_positions carries its autograd Function through o and
    lse; the backward launches K12 and K13 once each and matches the plain
    version's gradient of sum(o²) + sum(tanh(lse)) in fp32."""
    from nemo_tpu_torch.ops.flash_attention import flash_attention_positions, flash_pos_dkv, \
        flash_pos_dq

    qpos, kpos, _, _ = position_layout("off_diagonal", 256)
    g = torch.Generator().manual_seed(3)
    leaves = [torch.randn(1, h, 256, 64, generator=g) for h in (8, 2, 2)]
    grads = {}
    for dev in ("cpu", cuda):
        xs = [x.to(dev).requires_grad_() for x in leaves]
        o, lse = flash_attention_positions(*xs, qpos.to(dev), kpos.to(dev), 0.125)
        launches = flash_pos_dq.launches, flash_pos_dkv.launches
        grads[str(dev)] = [x.cpu() for x in torch.autograd.grad(
            o.square().sum() + torch.tanh(lse).sum(), xs)]
    assert (flash_pos_dq.launches, flash_pos_dkv.launches) == (launches[0] + 1, launches[1] + 1)
    for x, r in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(x, r, rtol=0, atol=1e-4 * float(r.abs().max()) + 1e-6)


@pytest.mark.parametrize("cp", [2, 4])
def test_ring_on_cuda_matches_causal_flash(cuda, cp):
    """ring_flash_attention with every rank in one process (LocalRing) on
    the card at S=2048, 8 heads over 2, bf16, against K5-K7's causal
    attention over the un-permuted sequence, row by row."""
    from nemo_tpu_torch.ops.ring_attention import LocalRing, ring_flash_attention, \
        zigzag_shard, zigzag_unshard

    S, H, G, dh = 2048, 8, 2, 64
    g = torch.Generator().manual_seed(cp)
    q, do = (torch.randn(1, H, S, dh, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(1, G, S, dh, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o_ref = flash_attention(*xs, 0.125)
    ref = torch.autograd.grad(o_ref, xs, do)
    Tl = S // cp
    zs = [zigzag_shard(x, cp, 2).view(1, x.shape[1], cp, Tl, dh).permute(2, 0, 1, 3, 4)
          .contiguous().requires_grad_() for x in (q, k, v)]
    o = ring_flash_attention(*zs, _zigzag_positions(S, cp).view(cp, Tl).to(cuda),
                             LocalRing(cp), scale=0.125)
    dz = zigzag_shard(do, cp, 2).view(1, H, cp, Tl, dh).permute(2, 0, 1, 3, 4)
    grads = torch.autograd.grad(o, zs, dz)
    unz = lambda t: zigzag_unshard(t.permute(1, 2, 0, 3, 4).reshape(  # noqa: E731
        1, t.shape[2], S, dh), cp, 2)
    _assert_rows_close(unz(o.detach()), o_ref, 2e-2, 1e-2, "o")
    for name, x, r in zip(("dq", "dk", "dv"), grads, ref):
        _assert_rows_close(unz(x), r, 3e-2, 1e-2, name)


def test_cp_llm_train_step_on_cuda(cuda):
    """A tiny Llama-style model (2 layers, 8 heads of 64 over 2, flash, full
    remat) at cp 2, every rank in one process: in fp32 the loss within 1e-5
    relative and every gradient within 1e-4 of its leaf's max-abs of the
    CPU's; in bf16 one train step launches K11 2·L·cp² times and K12, K13
    L·cp² times, none of K5-K10, with a loss within 2e-3 relative of the
    same step at cp 1."""
    import dataclasses

    from nemo_tpu_torch.models.llm.config import tiny_test
    from nemo_tpu_torch.models.llm.train import GPTTrainModule
    from nemo_tpu_torch.ops.flash_attention import flash_attention_positions, flash_pos_dkv, \
        flash_pos_dq

    cfg = tiny_test(hidden_size=512, num_attention_heads=8, num_query_groups=2, seq_length=512,
                    attention_backend="flash", remat="full", cp_size=2,
                    share_embeddings_and_output_weights=True, rope_scaling="llama3")
    rng = np.random.RandomState(2)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 512)))
             for k in ("tokens", "labels")}
    out = {}
    for dev in ("cpu", cuda):
        mod = GPTTrainModule(cfg, device=dev, seed=0)
        if dev != "cpu":
            mod.model.load_state_dict(cpu_state)
        cpu_state = mod.model.state_dict()
        loss = mod.loss(*(batch[k].to(dev) for k in ("tokens", "labels")))
        out[str(dev)] = (float(loss.detach()), [x.cpu() for x in torch.autograd.grad(
            loss, mod.params)])
    (loss, grads), (ref_loss, ref_grads) = out["cuda"], out["cpu"]
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for x, r in zip(grads, ref_grads):
        torch.testing.assert_close(x, r, rtol=0, atol=1e-4 * float(r.abs().max()) + 1e-6)

    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    one = GPTTrainModule(dataclasses.replace(bf, cp_size=1), device=cuda, seed=0)
    mod = GPTTrainModule(bf, device=cuda, seed=0)
    counters = (flash_attention_positions, flash_pos_dq, flash_pos_dkv, flash_attention, flash_dq,
                flash_dkv, flash_attention_packed, flash_seg_dq, flash_seg_dkv)
    launches = [fn.launches for fn in counters]
    m = mod.train_step(batch)
    torch.cuda.synchronize()
    got = tuple(fn.launches - n for fn, n in zip(counters, launches))
    L, cp = cfg.num_layers, 2
    assert got == (2 * L * cp * cp, L * cp * cp, L * cp * cp, 0, 0, 0, 0, 0, 0)
    ref = float(one.train_step(batch)["loss"])
    assert abs(float(m["loss"]) - ref) <= 2e-3 * abs(ref)


@pytest.mark.parametrize("dtype,gtol,ntol", [(torch.float32, 1e-4, 1e-5),
                                             (torch.bfloat16, 3e-2, 1e-2)])
@pytest.mark.parametrize("H,G,dh", [(8, 2, 64), (12, 12, 128)])
def test_positions_backward_with_more_keys_than_rows(cuda, H, G, dh, dtype, gtol, ntol):
    """K12 and K13 at Tq = 2048 rows against Tkv = 4096 keys (both multiples
    of 64, not equal): rows at even positions 0 .. 4094, keys at 1024 ..
    5119, so that the first 512 rows keep no key and get dq = 0 exactly;
    against the plain backward with a nonzero lse cotangent, row by row."""
    from nemo_tpu_torch.ops.flash_attention import (
        _k11_launch, flash_attention_positions_backward_plain, flash_pos_dkv, flash_pos_dq,
        pos_delta)

    B, Tq, Tkv, scale = 1, 2048, 4096, 1.0 / math.sqrt(dh)
    qpos = (2 * torch.arange(Tq, dtype=torch.int32)).to(cuda)
    kpos = (1024 + torch.arange(Tkv, dtype=torch.int32)).to(cuda)
    g = torch.Generator().manual_seed(dh + H)
    q, do = (torch.randn(B, Tq, H, dh, generator=g).to(cuda, dtype).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn(B, Tkv, G, dh, generator=g).to(cuda, dtype).transpose(1, 2)
            for _ in range(2))
    dlse = torch.randn(B, H, Tq, generator=g).to(cuda)
    o, lse = _k11_launch(q, k, v, qpos, kpos, scale, True, None)
    o = o.transpose(1, 2)
    dead = qpos < 1024
    assert int(dead.sum()) == 512 and bool((lse[:, :, dead] == -1e30).all())
    args = (q, k, v, qpos, kpos, scale, True, None, lse, pos_delta(o, do, dlse), do)
    out = (flash_pos_dq(*args), *flash_pos_dkv(*args))
    ref = flash_attention_positions_backward_plain(q, k, v, qpos, kpos, scale, True, None, o,
                                                   lse, do, dlse)
    torch.cuda.synchronize()
    for name, x, r in zip(("dq", "dk", "dv"), out, ref):
        assert x.shape == r.shape and x.dtype == dtype, name
        _assert_rows_close(x, r, gtol, ntol, name)
    assert bool((out[0][:, :, dead] == 0).all())


def test_bf16_forward_kernels_k1_k2_are_deterministic(cuda):
    """Two launches of the bf16 K1 and K2 on the same inputs give the same
    bits: neither sums across blocks (no atomics)."""
    lengths = [751, 700, 613, 1]
    args = [a.to(cuda, torch.bfloat16) if torch.is_tensor(a) and a.is_floating_point() else
            (a.to(cuda) if torch.is_tensor(a) else a)
            for a in _attention_inputs(len(lengths), 8, 751, lengths, seed=13)]
    first, second = relpos_flash_attention(*args), relpos_flash_attention(*args)
    sub = [a.to(cuda, torch.bfloat16) for a in _subsampling_inputs(2, 3001, 80, 512, seed=14)]
    out1, out2 = fused_subsampling_x4(*sub), fused_subsampling_x4(*sub)
    torch.cuda.synchronize()
    for name, x, y in (("o", first[0], second[0]), ("lse", first[1], second[1]),
                       ("subsampling", out1, out2)):
        assert torch.isfinite(x.float()).all() and x.abs().sum() > 0, name
        assert torch.equal(x, y), name


def test_bf16_relpos_backward_kernels_are_deterministic(cuda):
    """Two launches of the bf16 K3 and K4 on the same inputs give the same
    bits for dqu, dqv, dk and dv (each block sums its own rows and keys in
    registers); dp, summed across blocks by TMA reductions, may differ in its
    last bits and is held to the plain backward by the test above."""
    lengths = [751, 700, 613, 500]
    args = [a.to(cuda, torch.bfloat16) if torch.is_tensor(a) and a.is_floating_point() else
            (a.to(cuda) if torch.is_tensor(a) else a)
            for a in _attention_inputs(len(lengths), 8, 751, lengths, seed=11)]
    o, lse = relpos_flash_attention(*args)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(12)).to(cuda, torch.bfloat16)
    delta = row_delta(o, do)
    first = (*relpos_flash_dq(*args, lse, delta, do), *relpos_flash_dkv(*args, lse, delta, do)[:2])
    second = (*relpos_flash_dq(*args, lse, delta, do), *relpos_flash_dkv(*args, lse, delta, do)[:2])
    torch.cuda.synchronize()
    for name, x, y in zip(("dqu", "dqv", "dk", "dv"), first, second):
        assert torch.isfinite(x.float()).all() and x.abs().sum() > 0, name
        assert torch.equal(x, y), name


def test_bf16_relpos_kernels_dh128_are_deterministic(cuda):
    """Two launches of the bf16 K1, K3 and K4 at head dim 128 on the same
    inputs give the same bits for o, lse, dqu, dqv, dk and dv (dp, summed
    across blocks, is held to the plain backward above)."""
    lengths = [376, 300, 1, 250]
    args = [a.to(cuda, torch.bfloat16) if torch.is_tensor(a) and a.is_floating_point() else
            (a.to(cuda) if torch.is_tensor(a) else a)
            for a in _attention_inputs(len(lengths), 8, 376, lengths, seed=15, dh=128)]
    runs = []
    for _ in range(2):
        o, lse = relpos_flash_attention(*args)
        do = torch.randn(o.shape, generator=torch.Generator().manual_seed(16)).to(
            cuda, torch.bfloat16)
        delta = row_delta(o, do)
        runs.append((o, lse, *relpos_flash_dq(*args, lse, delta, do),
                     *relpos_flash_dkv(*args, lse, delta, do)[:2]))
    torch.cuda.synchronize()
    for name, x, y in zip(("o", "lse", "dqu", "dqv", "dk", "dv"), *runs):
        assert torch.isfinite(x.float()).all() and x.abs().sum() > 0, name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("form", ["causal", "packed", "positions"])
def test_bf16_backward_kernels_are_deterministic(cuda, form):
    """Two launches of each bf16 backward kernel on the same inputs give the
    same bits: K6 and K7 (causal, S=2048), K9 and K10 (the packed layout),
    K12 and K13 (the off-diagonal ring step at 512 rows a rank). No atomics:
    dk and dv are summed over a kv group's heads in registers."""
    from nemo_tpu_torch.ops.flash_attention import (_k5_launch, _k8_launch, _k11_launch,
                                                    flash_pos_dkv, flash_pos_dq, pos_delta)

    g = torch.Generator().manual_seed(7)
    H, G, dh, scale = 8, 2, 64, 0.125
    if form == "positions":
        qpos, kpos, _, _ = position_layout("off_diagonal", 512)
        qpos, kpos = qpos.to(cuda), kpos.to(cuda)
    T = 512 if form == "positions" else 2048
    q, do = (torch.randn(2, T, H, dh, generator=g).to(cuda, torch.bfloat16).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn(2, T, G, dh, generator=g).to(cuda, torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    if form == "causal":
        o, lse = _k5_launch(q, k, v, scale, True, None)
        args = (q, k, v, scale, True, None, lse, row_delta(o.transpose(1, 2), do), do)
        dq_fn, dkv_fn = flash_dq, flash_dkv
    elif form == "packed":
        seg = packed_segments("packed", T).to(cuda)
        o, lse = _k8_launch(q, k, v, seg, seg_tile_ranges(seg), scale, True, None)
        args = (q, k, v, seg, scale, True, None, lse, row_delta(o.transpose(1, 2), do), do)
        dq_fn, dkv_fn = flash_seg_dq, flash_seg_dkv
    else:
        o, lse = _k11_launch(q, k, v, qpos, kpos, scale, True, None)
        args = (q, k, v, qpos, kpos, scale, True, None, lse, pos_delta(o.transpose(1, 2), do),
                do)
        dq_fn, dkv_fn = flash_pos_dq, flash_pos_dkv
    first = (dq_fn(*args), *dkv_fn(*args))
    second = (dq_fn(*args), *dkv_fn(*args))
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.isfinite(x.float()).all() and x.abs().sum() > 0, name
        assert torch.equal(x, y), name
