"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and nvcc (the kernels build at first
use) and skips without them.  The file imports neither `jax` nor `repro`,
so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: K1's residual', keep set and nnz bitwise, its noised upload
within 2e-6 · max(1, σS) (the noise's log/cos are libm's in the kernel and
PyTorch's CUDA math in the plain version); K2 bitwise (both compute each
gated step as one fma(a, cur, b·ω)); K3 equal; K4 bitwise as int32 views;
K5 within 2e-6 · max(1, σS), as K1, and bitwise against K1 with flags 6
or 2 (the same function from K1's own source); K1 against the K4 -> K3 ->
K5 kernel chain bitwise (one noise header, the same rounded operations);
K6 within 1e-5 at unit-scale inputs in float32 (the kernel and the plain version sum
over up to 2,048 keys in other orders), plus one bf16 ulp of the larger
value in bfloat16 (each rounds one float32 result once); K8 and K7 within
5e-6 of the output's largest magnitude (y reaches 10-35; the kernels sum
in other orders than the plain versions and use CUDA's expf; readings
under 1e-6 of it), plus one bf16 ulp of the larger value for a bfloat16
y; a small model forward with K6 on the card within 1e-4 of the CPU, as
the CPU parity tests hold the port to the reference, and the two-layer
falcon-mamba and zamba2 likewise; the reference backend's noise chain
(threefry -> uniform -> erf_inv) bitwise against the CPU, and the small
buffered, trust and reference-noise runs as the network run.  The
observability and simulation layers: `obs.fence` waits for the card; a
traced 1,000-node window, and a run resumed from a checkpoint on the
card, are bit for bit their untraced and uninterrupted twins; a
checkpoint written on the card restores on the CPU with equal arrays.
"""
import numpy as np
import pytest
import torch

from repro_torch import api, tree
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ldp_noise as ldp
from repro_torch.kernels.ops import attention_pallas
from repro_torch.launch.serve import prompts, request_batch, serve
from repro_torch.models import forward, init_params
from repro_torch.models.ssm import softplus
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels import sparsify as sp
from repro_torch.kernels import ssd_scan as sd
from repro_torch.kernels import upload_fused as uf
from repro_torch.kernels import window_fold as wf
from repro_torch.kernels import wire_bytes as wb

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _upload_args(dev, k, sizes, ratio, sigma, seed):
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    offs = tuple(int(b) for b in np.cumsum((0,) + tuple(sizes))[:-1])
    flat = torch.tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    res = torch.tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    thr = torch.tensor(rng.random((k, len(sizes))).astype(np.float32),
                       device=dev) if ratio < 1.0 else None
    seeds = torch.tensor(rng.integers(-2**31, 2**31, k).astype(np.int32),
                         device=dev)
    scales = torch.tensor((rng.random(k) + 0.5).astype(np.float32),
                          device=dev) if sigma > 0 else None
    return (flat, res if ratio < 1.0 else None, thr, seeds, scales, sigma,
            1.3), offs


@pytest.mark.parametrize("need_nnz", [True, False])
@pytest.mark.parametrize("ratio,sigma", [(0.3, 0.0), (1.0, 0.5), (0.3, 0.5)])
@pytest.mark.parametrize("k,sizes", [(3, (700, 1301, 96)),
                                     (1, (150000, 120001))])
def test_upload_fused_kernel_matches_plain(cuda, k, sizes, ratio, sigma,
                                           need_nnz):
    """(700, 1301, 96): an awkward leaf layout; one row with P = 270,001
    crosses into the second noise tile (P > 262,144)."""
    args, offs = _upload_args(cuda, k, sizes, ratio, sigma, seed=k)
    before = uf.upload_fused_fleet.launches
    uk, rk, nk = uf.upload_fused_fleet(*args, boundaries=offs,
                                       need_nnz=need_nnz)
    up, rp, npl = uf.upload_fused_plain(*args, boundaries=offs,
                                        need_nnz=need_nnz)
    torch.cuda.synchronize()
    assert uf.upload_fused_fleet.launches == before + 1
    if need_nnz:
        assert torch.equal(nk, npl)
    else:
        assert nk is None and npl is None
    if ratio < 1.0:
        assert torch.equal(rk, rp)
    if sigma == 0.0:
        assert torch.equal(uk, up)
    else:
        assert float((uk - up).abs().max()) <= 2e-6 * max(1.0, sigma * 1.3)


@pytest.mark.parametrize("c,n", [(5, 4097), (1100, 300)])
def test_window_fold_kernel_matches_plain_bitwise(cuda, c, n):
    """(1100, 300) spans two of the kernel's 1,024-arrival staging chunks."""
    rng = np.random.default_rng(c)
    p = torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
    om = torch.tensor(rng.normal(size=(c, n)).astype(np.float32),
                      device=cuda)
    gates = torch.tensor(rng.random(c) < 0.6, device=cuda)
    b = torch.tensor(rng.random(c).astype(np.float32), device=cuda)
    a = 1.0 - b
    before = wf.window_fold_fleet.launches
    fk, sk = wf.window_fold_fleet(p, om, gates, a, b)
    fp, sp = wf.window_fold_plain(p, om, gates, a, b)
    torch.cuda.synchronize()
    assert wf.window_fold_fleet.launches == before + 1
    assert torch.equal(fk, fp) and torch.equal(sk, sp)


def _flagged_upload(dev, k, sizes, flags, seed):
    """K1's inputs for the kernel's flag bits (1 sparsify, 2 clip scale,
    4 noise, 8 nnz): (args, leaf starts, need_nnz)."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    offs = tuple(int(b) for b in np.cumsum((0,) + tuple(sizes))[:-1])

    def normal(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device=dev)

    flat, res = normal(k, n), normal(k, n)
    thr = torch.tensor(rng.random((k, len(sizes))).astype(np.float32),
                       device=dev)
    seeds = torch.tensor(rng.integers(-2**31, 2**31, k).astype(np.int32),
                         device=dev)
    scales = torch.tensor((rng.random(k) + 0.5).astype(np.float32),
                          device=dev)
    args = (flat, res if flags & 1 else None, thr if flags & 1 else None,
            seeds, scales if flags & 2 else None,
            0.5 if flags & 4 else 0.0, 1.3)
    return args, offs, bool(flags & 8)


def _assert_upload_matches_plain(args, offs, need_nnz):
    before = uf.upload_fused_fleet.launches
    uk, rk, nk = uf.upload_fused_fleet(*args, boundaries=offs,
                                       need_nnz=need_nnz)
    up, rp, npl = uf.upload_fused_plain(*args, boundaries=offs,
                                        need_nnz=need_nnz)
    torch.cuda.synchronize()
    assert uf.upload_fused_fleet.launches == before + 1
    assert (nk is None) == (not need_nnz)
    if need_nnz:
        assert torch.equal(nk, npl)
    if args[1] is not None:
        assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    sigma_s = args[5] * args[6] if args[4] is not None else 0.0
    if sigma_s == 0.0:
        assert torch.equal(uk.view(torch.int32), up.view(torch.int32))
    else:
        assert float((uk - up).abs().max()) <= 2e-6 * max(1.0, sigma_s)
    return uk, rk, nk


@pytest.mark.parametrize("flags", [15, 14, 11, 9, 7, 6])
@pytest.mark.parametrize("k,sizes", [
    (5, (1,)), (5, (2,)), (5, (3,)),               # rows shorter than a run
    (7, (4097,)), (7, (4098,)), (7, (4099,)),       # N = 1, 2, 3 mod 4
    (6, (5, 1, 2, 3, 1, 4, 2049))])                 # starts inside runs
def test_upload_fused_kernel_edges_match_plain(cuda, k, sizes, flags):
    """The kernel moves 4-element runs on 16-byte boundaries, with a head
    and a tail per row: rows of every length mod 4 and shorter than a run,
    leaf starts inside a run (leaves of 1-3 elements put several in one),
    with noise but no sparsification (flags 6, 14), nnz without the clip
    scale (9), and the paper's paths' flags (7, 15)."""
    _assert_upload_matches_plain(*_flagged_upload(cuda, k, sizes, flags,
                                                  seed=k + flags))


def test_upload_fused_kernel_takes_64_leaves_and_refuses_65(cuda):
    sizes = tuple(range(1, 65))                     # 64 leaves, N = 2,080
    _assert_upload_matches_plain(*_flagged_upload(cuda, 3, sizes, 15, 2))
    args, offs, _ = _flagged_upload(cuda, 3, sizes + (7,), 15, 2)
    before = uf.upload_fused_fleet.launches
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        uf.upload_fused_fleet(*args, boundaries=offs, need_nnz=True)
    assert uf.upload_fused_fleet.launches == before


def test_upload_fused_kernel_reads_unaligned_views(cuda):
    """Inputs that start 4 bytes past a 16-byte boundary give the bits of
    the same values in fresh tensors."""
    args, offs, need_nnz = _flagged_upload(cuda, 3, (4099,), 15, 4)
    aligned = _assert_upload_matches_plain(args, offs, need_nnz)
    shifted = []
    for t in args[:2]:
        buf = torch.empty(t.numel() + 1, device=cuda)
        view = buf[1:].view_as(t)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        shifted.append(view)
    got = _assert_upload_matches_plain(tuple(shifted) + args[2:], offs,
                                       need_nnz)
    for x, y in zip(aligned, got):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("c,n,share", [
    (1, 4097, 1.0), (3, 300, 0.6), (37, 1000, 0.6), (40, 2049, 0.0),
    (2100, 65, 0.6), (2100, 130, 0.6), (256, 20490, 0.7)])
def test_window_fold_kernel_edges_match_plain_bitwise(cuda, c, n, share):
    """The kernel keeps 32 arrivals of each column in flight: one arrival,
    fewer than the ring holds (3), a count that is no multiple of it (37),
    every gate off (the params pass through bitwise), more than two
    1,024-arrival staging chunks (at 65 and 130 columns, whose last block
    of 128 columns runs past the row's end), and the main path's
    (256, 20490)."""
    rng = np.random.default_rng(c + n)
    p = torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
    om = torch.tensor(rng.normal(size=(c, n)).astype(np.float32),
                      device=cuda)
    gates = torch.tensor(rng.random(c) < share, device=cuda)
    b = torch.tensor(rng.random(c).astype(np.float32), device=cuda)
    a = 1.0 - b
    before = wf.window_fold_fleet.launches
    fk, sk = wf.window_fold_fleet(p, om, gates, a, b)
    fp, sp = wf.window_fold_plain(p, om, gates, a, b)
    torch.cuda.synchronize()
    assert wf.window_fold_fleet.launches == before + 1
    assert torch.equal(fk.view(torch.int32), fp.view(torch.int32))
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))
    if share == 0.0:
        assert torch.equal(fk.view(torch.int32), p.view(torch.int32))
        assert torch.equal(sk.view(torch.int32),
                           p.expand(c, n).view(torch.int32))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        uf.upload_fused_fleet(x.double(), None, None, None,
                              torch.ones(2, device=cuda), 0.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        uf.upload_fused_fleet(torch.zeros(8, 2, device=cuda).t(), None, None,
                              None, torch.ones(2, device=cuda), 0.0, 1.0)
    with pytest.raises(ValueError, match="p_flat"):
        wf.window_fold_fleet(torch.zeros(8), x,
                             torch.ones(2, device=cuda),
                             torch.ones(2, device=cuda),
                             torch.ones(2, device=cuda))


def _small_run_on_card_and_cpu(sigma, backend):
    """The same small async run through `api.run` on the card (kernels)
    and on the CPU (plain versions): equal records, accuracy within
    1/n_test, params within 1e-4 (the limits `test_torch_api.py` holds the
    port to the reference with); both kernels launched on the card."""
    spec = api.ExperimentSpec(
        fleet=api.FleetSpec(n_nodes=8, model="cnn", hw=(14, 14),
                            samples_per_node=40, n_test=128, n_cloud_test=64,
                            attack=api.AttackMix(malicious_frac=0.25)),
        schedule=api.SchedulePolicy(kind="async"),
        privacy=api.PrivacySpec(sigma=sigma),
        compression=api.CompressionSpec(sparsify_ratio=0.1),
        defense=api.DefenseSpec(detect=True),
        topology=api.Topology(backend=backend), rounds=2)
    plan = api.compile_plan(spec)
    pop = api.materialize(spec, device="cpu")
    launches = (uf.upload_fused_fleet.launches, wf.window_fold_fleet.launches)
    r_gpu = api.run(plan, population=pop, device="cuda")
    assert uf.upload_fused_fleet.launches > launches[0]
    assert wf.window_fold_fleet.launches > launches[1]
    r_cpu = api.run(plan, population=pop, device="cpu")
    for a, b in zip(r_cpu.records, r_gpu.records):
        assert (a.t, a.version, a.comm_bytes, a.n_rejected) == \
            (b.t, b.version, b.comm_bytes, b.n_rejected)
        assert abs(a.accuracy - b.accuracy) <= 1.0 / 128
    for x, y in zip(tree.leaves(r_cpu.final_params),
                    tree.leaves(r_gpu.final_params)):
        assert float((x - y.cpu()).abs().max()) <= 1e-4


def test_small_aldpfl_run_on_the_card_matches_the_cpu(cuda):
    _small_run_on_card_and_cpu(0.05, "pallas")


def test_reference_backend_runs_the_kernels_on_the_card(cuda):
    """backend="reference" (σ=0) takes the same kernel path on the card."""
    _small_run_on_card_and_cpu(0.0, "reference")


@pytest.mark.parametrize("k,n", [(5, 3000), (2, 300001), (1000, 20490)])
def test_nnz_kernel_matches_plain(cuda, k, n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(k, n)).astype(np.float32)
    x[rng.random((k, n)) < rng.random((k, 1))] = 0.0
    x[0, :3] = -0.0
    x[-1, 5] = np.nan
    xt = torch.tensor(x, device=cuda)
    before = wb.nnz_fleet.launches
    got = wb.nnz_fleet(xt)
    torch.cuda.synchronize()
    assert wb.nnz_fleet.launches == before + 1
    assert torch.equal(got, wb.nnz_plain(xt))


@pytest.mark.parametrize("k,n", [(4, 3000), (1000, 4608)])
def test_sparsify_kernel_matches_plain_bitwise(cuda, k, n):
    rng = np.random.default_rng(k)
    g = torch.tensor(rng.normal(size=(k, n)).astype(np.float32), device=cuda)
    r = torch.tensor(rng.normal(size=(k, n)).astype(np.float32), device=cuda)
    thr = (g + r)[:, 7].abs().contiguous()          # exact ties
    g[0, :10] = -0.0
    r[0, :10] = -0.0
    thr[0] = 0.0                                    # c = -0.0 is kept
    before = sp.sparsify_fleet.launches
    uk, rk = sp.sparsify_fleet(g, r, thr)
    up, rp = sp.sparsify_plain(g, r, thr)
    u1, r1 = sp.sparsify_flat(g[1], r[1], thr[1])
    torch.cuda.synchronize()
    assert sp.sparsify_fleet.launches == before + 2
    assert torch.equal(uk.view(torch.int32), up.view(torch.int32))
    assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    assert torch.equal(u1.view(torch.int32), up[1].view(torch.int32))
    assert torch.equal(r1.view(torch.int32), rp[1].view(torch.int32))


@pytest.mark.parametrize("sigma", [0.0, 0.05, 0.7])
@pytest.mark.parametrize("k,n", [(3, 2000), (4, 300001)])
def test_ldp_noise_kernel_matches_plain(cuda, k, n, sigma):
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(k, n)).astype(np.float32), device=cuda)
    seeds = torch.tensor(rng.integers(-2**31, 2**31, k).astype(np.int32),
                         device=cuda)
    scales = torch.tensor((rng.random(k) + 0.5).astype(np.float32),
                          device=cuda)
    before = ldp.ldp_perturb_fleet.launches
    yk = ldp.ldp_perturb_fleet(x, seeds, scales, sigma, 1.3)
    yp = ldp.ldp_perturb_plain(x, seeds, scales, sigma, 1.3)
    y1 = ldp.ldp_perturb_flat(x[1], seeds[1], scales[1], sigma, 1.3)
    torch.cuda.synchronize()
    assert ldp.ldp_perturb_fleet.launches == before + 2
    assert float((yk - yp).abs().max()) <= 2e-6 * max(1.0, sigma * 1.3)
    assert torch.equal(y1, yk[1])


@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_fused_kernel_equals_the_kernel_chain_bitwise(cuda, sigma):
    """One K1 launch against K4 per leaf -> K3 -> K5 on the card, with the
    same per-leaf thresholds, seeds and clip scales."""
    sizes = (16, 144, 32, 4608, 10, 15680)
    k, n = 64, sum(sizes)
    offs = tuple(int(b) for b in np.cumsum((0,) + sizes)[:-1])
    rng = np.random.default_rng(1)
    g = torch.tensor(rng.normal(size=(k, n)).astype(np.float32) * 1e-2,
                     device=cuda)
    r = torch.tensor(rng.normal(size=(k, n)).astype(np.float32) * 1e-2,
                     device=cuda)
    thr = torch.stack([(g + r)[:, o:o + s].abs().quantile(0.9, dim=1)
                       for o, s in zip(offs, sizes)], dim=1).contiguous()
    ups, news = zip(*(sp.sparsify_fleet(g[:, o:o + s].contiguous(),
                                        r[:, o:o + s].contiguous(),
                                        thr[:, i].contiguous())
                      for i, (o, s) in enumerate(zip(offs, sizes))))
    up4, r4 = torch.cat(ups, dim=1), torch.cat(news, dim=1)
    nnz3 = wb.nnz_fleet(up4)
    scales = 1.0 / torch.clamp(torch.sqrt((up4 * up4).sum(1)), min=1.0)
    seeds = torch.tensor(rng.integers(-2**31, 2**31, k).astype(np.int32),
                         device=cuda)
    up5 = ldp.ldp_perturb_fleet(up4, seeds, scales, sigma, 1.0)
    up1, r1, nnz1 = uf.upload_fused_fleet(g, r, thr, seeds, scales, sigma,
                                          1.0, boundaries=offs,
                                          need_nnz=True)
    torch.cuda.synchronize()
    assert torch.equal(up1.view(torch.int32), up5.view(torch.int32))
    assert torch.equal(r1.view(torch.int32), r4.view(torch.int32))
    assert torch.equal(nnz1, nnz3)


def _nnz_rows(dev, k, n, o, seed):
    """(k, n) float32 rows in a buffer, starting ``o`` elements (4·o
    bytes) past a 16-byte boundary: row i is all zeros (with -0.0 among
    them), all nonzero or of mixed sparsity by (i + o) mod 4, and the last
    row holds a -0.0 and a NaN."""
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(k, n, generator=gen, device=dev)
    share = torch.rand(k, 1, generator=gen, device=dev)
    x = torch.where(torch.rand(k, n, generator=gen, device=dev) < share, x,
                    torch.zeros((), device=dev))
    kind = (torch.arange(k, device=dev)[:, None] + o) % 4
    x = torch.where(kind == 0, torch.zeros((), device=dev), x)
    x[kind[:, 0] == 0, ::3] = -0.0
    x = torch.where((kind == 1) & (x == 0), torch.ones((), device=dev), x)
    x[-1, n // 2] = float("nan")
    x[-1, (n - 1) // 3] = -0.0
    buf = torch.empty(k * n + 4, device=dev)
    view = buf[o:o + k * n].view(k, n)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4 * o
    return view


@pytest.mark.parametrize("n", [1, 2, 3, 5, 4097, 20490, 300001])
@pytest.mark.parametrize("k", [1, 2, 7, 1000])
def test_nnz_kernel_counts_rows_at_every_alignment(cuda, k, n):
    """K3 reads 16-byte vectors between a scalar head and tail that it
    finds from each segment's own address: rows starting 0, 4, 8 and 12
    bytes off a 16-byte boundary (and, at odd n, every row at another
    one), rows shorter than a vector, all-zero and all-nonzero rows, -0.0
    (not counted) and NaN (counted), through both launches (one block a
    row at K = 1,000; a row split over blocks into a zeroed output at K
    <= 7 with long rows)."""
    for o in range(4):
        x = _nnz_rows(cuda, k, n, o, seed=k * 7 + n + o)
        before = wb.nnz_fleet.launches
        got = wb.nnz_fleet(x)
        want = wb.nnz_plain(x)
        torch.cuda.synchronize()
        assert wb.nnz_fleet.launches == before + 1
        assert torch.equal(got, want), (o, (got - want).abs().max())


def test_nnz_kernel_runs_both_launches(cuda):
    """The shapes above reach both launches on this card, and a split
    row's blocks add up to the count of the whole row."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert not wb.nnz_grid(1000, 20490, sms).zeroed
    assert not wb.nnz_grid(7, 5, sms).zeroed
    split = wb.nnz_grid(1, 300001, sms)
    assert split.zeroed and split.blocks_per_row > 1
    x = torch.ones(1, 300001, device=cuda)
    x[0, ::7] = 0.0
    assert int(wb.nnz_fleet(x)[0]) == 300001 - len(range(0, 300001, 7))


def _ldp_args(dev, k, n, sigma, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    seeds = torch.tensor(rng.integers(-2**31, 2**31, k).astype(np.int32),
                         device=dev)
    scales = torch.tensor((rng.random(k) + 0.5).astype(np.float32),
                          device=dev)
    return x, seeds, scales, sigma, 1.3


def _assert_ldp_is_k1(args):
    """K5 on ``args`` against its plain version (2e-6 · max(1, σS)) and
    bitwise against K1 with flags 6 (σS > 0) or 2 on the same inputs."""
    x, seeds, scales, sigma, clip_s = args
    before = ldp.ldp_perturb_fleet.launches
    yk = ldp.ldp_perturb_fleet(*args)
    yp = ldp.ldp_perturb_plain(*args)
    y1 = uf.upload_fused_fleet(x, None, None, seeds, scales, sigma,
                               clip_s)[0]
    torch.cuda.synchronize()
    assert ldp.ldp_perturb_fleet.launches == before + 1
    assert float((yk - yp).abs().max()) <= 2e-6 * max(1.0, sigma * clip_s)
    assert torch.equal(yk.view(torch.int32), y1.view(torch.int32))
    return yk


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("k,n", [
    (5, 1), (5, 2), (5, 3), (4, 5),                 # rows shorter than a run
    (7, 4097), (3, 20490), (6, 270001)])            # ragged; P > 2^18
def test_ldp_noise_kernel_equals_k1_bitwise(cuda, k, n, sigma):
    """K5 moves runs of 8 (noise) or 4 elements on 16-byte boundaries, with
    a head and a tail per row; K1 with flags 6 or 2 computes the same
    function from its own source, so the two agree bit for bit at every
    head length 0-3 (rows of n = 1 mod 4 start at each), across the
    second noise tile and on rows shorter than a run."""
    heads = {(-(i * n)) % 4 for i in range(k)}
    if n % 4 == 1 and k >= 4:
        assert heads == {0, 1, 2, 3}
    _assert_ldp_is_k1(_ldp_args(cuda, k, n, sigma, seed=k + n))


@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_ldp_noise_kernel_reads_unaligned_views(cuda, sigma):
    """`ldp_perturb_flat(x[1])` of a (2, 20490) cohort starts 8 bytes off
    a 16-byte boundary, as does a (3, 4097) view with a storage offset:
    the wrapper hands the kernel an aligned copy, and the bits are those
    of the aligned rows."""
    x, seeds, scales, _, clip_s = _ldp_args(cuda, 2, 20490, sigma, seed=5)
    assert x[1].data_ptr() % 16 == 8
    y = _assert_ldp_is_k1((x, seeds, scales, sigma, clip_s))
    y1 = ldp.ldp_perturb_flat(x[1], seeds[1], scales[1], sigma, clip_s)
    assert torch.equal(y1.view(torch.int32), y[1].view(torch.int32))
    args = _ldp_args(cuda, 3, 4097, sigma, seed=6)
    buf = torch.empty(3 * 4097 + 2, device=cuda)
    view = buf[2:].view(3, 4097)
    view.copy_(args[0])
    assert view.data_ptr() % 16 == 8
    want = _assert_ldp_is_k1(args)
    got = _assert_ldp_is_k1((view,) + args[1:])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_small_network_run_on_the_card_matches_the_cpu(cuda):
    """The lossy async network run on the card and on the CPU: equal
    records and `RunReport.net`, params within 1e-4."""
    spec = api.ExperimentSpec(
        fleet=api.FleetSpec(n_nodes=8, model="cnn", hw=(14, 14),
                            samples_per_node=40, n_test=128, n_cloud_test=64,
                            attack=api.AttackMix(malicious_frac=0.25)),
        schedule=api.SchedulePolicy(kind="async"),
        privacy=api.PrivacySpec(sigma=0.05),
        compression=api.CompressionSpec(sparsify_ratio=0.1),
        defense=api.DefenseSpec(detect=True),
        network=api.NetworkSpec(codec="sparse_bitpack", bandwidth_sigma=1.0,
                                latency_s=0.02, jitter_s=0.1,
                                loss_prob=0.2),
        topology=api.Topology(backend="pallas"), rounds=2)
    plan = api.compile_plan(spec)
    pop = api.materialize(spec, device="cpu")
    r_gpu = api.run(plan, population=pop, device="cuda")
    r_cpu = api.run(plan, population=pop, device="cpu")
    assert r_gpu.net == r_cpu.net
    for a, b in zip(r_cpu.records, r_gpu.records):
        assert (a.t, a.version, a.comm_bytes, a.comm_time, a.n_rejected,
                a.bytes_source) == (b.t, b.version, b.comm_bytes,
                                    b.comm_time, b.n_rejected,
                                    b.bytes_source)
        assert abs(a.accuracy - b.accuracy) <= 1.0 / 128
    for x, y in zip(tree.leaves(r_cpu.final_params),
                    tree.leaves(r_gpu.final_params)):
        assert float((x - y.cpu()).abs().max()) <= 1e-4


def test_reference_noise_chain_on_the_card_matches_the_cpu(cuda):
    """The reference backend's noise (threefry bits -> uniform -> XLA's
    float32 erf_inv, `core.aldp.leaf_bits` over the CNN's six leaves) on
    the card and on the CPU: bits, uniforms and normals bitwise (the chain
    is integer and correctly rounded float arithmetic on both)."""
    from repro_torch import prng
    from repro_torch.core import aldp

    sizes = (16, 144, 32, 4608, 10, 15680)
    keys = prng.split(prng.PRNGKey(11), 24)
    bits = {d: aldp.leaf_bits(keys, sizes, d) for d in ("cpu", cuda)}
    assert torch.equal(bits["cpu"], bits[cuda].cpu())
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    for fn in (lambda b: prng.uniform_from_bits(b),
               lambda b: prng.uniform_from_bits(b, lo, 1.0),
               lambda b: prng.normal_from_bits(b, 0.05)):
        want, got = fn(bits["cpu"]), fn(bits[cuda]).cpu()
        assert torch.equal(want.view(torch.int32), got.view(torch.int32))
    flat = torch.randn(24, sum(sizes), generator=torch.Generator()
                       .manual_seed(0))
    want, _ = aldp.perturb_flat(flat, keys, sizes, 0.05, 1.0)
    got, _ = aldp.perturb_flat(flat.to(cuda), keys, sizes, 0.05, 1.0)
    assert float((want - got.cpu()).abs().max()) <= 2e-6


@pytest.mark.parametrize("case", ["buffered", "trust-sybil",
                                  "sync-trust-adaptive", "reference-noise"])
def test_small_zoo_runs_on_the_card_match_the_cpu(cuda, case):
    """The reference-noise, buffered and trust paths, small, on the card
    and on the CPU: equal records, params within 1e-4; K1 launches on
    each, and K2 on the sequential folds but not on the buffered one."""
    kind = {"buffered": "buffered", "sync-trust-adaptive": "sync"}.get(
        case, "async")
    attack = {"trust-sybil": "sybil", "sync-trust-adaptive": "adaptive"}
    spec = api.ExperimentSpec(
        fleet=api.FleetSpec(n_nodes=8, model="cnn", hw=(14, 14),
                            samples_per_node=40, n_test=128, n_cloud_test=64,
                            attack=api.AttackMix(
                                malicious_frac=0.25,
                                kind=attack.get(case, "label_flip"))),
        schedule=api.SchedulePolicy(kind=kind,
                                    staleness_adaptive=kind == "buffered"),
        privacy=api.PrivacySpec(sigma=0.05),
        compression=api.CompressionSpec(sparsify_ratio=0.1),
        defense=api.DefenseSpec(detect=True, kind=(
            "trust_weighted" if "trust" in case else "percentile")),
        topology=api.Topology(backend=("reference" if case ==
                                       "reference-noise" else "pallas")),
        rounds=2)
    plan = api.compile_plan(spec)
    pop = api.materialize(spec, device="cpu")
    k1, k2 = uf.upload_fused_fleet.launches, wf.window_fold_fleet.launches
    r_gpu = api.run(plan, population=pop, device="cuda")
    assert uf.upload_fused_fleet.launches > k1
    assert (wf.window_fold_fleet.launches > k2) == (kind == "async")
    r_cpu = api.run(plan, population=pop, device="cpu")
    assert len(r_cpu.records) == len(r_gpu.records) >= 2
    for a, b in zip(r_cpu.records, r_gpu.records):
        assert (a.t, a.version, a.comm_bytes, a.n_rejected) == \
            (b.t, b.version, b.comm_bytes, b.n_rejected)
        assert abs(a.accuracy - b.accuracy) <= 1.0 / 128
    for x, y in zip(tree.leaves(r_cpu.final_params),
                    tree.leaves(r_gpu.final_params)):
        assert float((x - y.cpu()).abs().max()) <= 1e-4


@pytest.mark.parametrize("b,h,kv,s,d,dtype,window", [
    (8, 15, 5, 2048, 64, torch.bfloat16, 0),     # smollm-360m, causal
    (8, 32, 32, 2048, 64, torch.bfloat16, 0),    # zamba2-1.2b's shared block
    (8, 15, 5, 2048, 64, torch.bfloat16, 256),   # the same, window 256
    (2, 4, 2, 1000, 64, torch.float32, 0),       # unaligned: padding
    (1, 3, 1, 77, 80, torch.float32, 20),        # head_dim 80, tiny window
    (2, 4, 2, 200, 128, torch.bfloat16, 0),      # tensor cores: 3 q terms
    (1, 3, 1, 77, 80, torch.bfloat16, 20),       # D padded to 96, 3 q terms
    (2, 4, 2, 1000, 64, torch.bfloat16, 0),      # unaligned tail of keys
    (2, 64, 8, 2048, 112, torch.bfloat16, 0),    # kimi-k2: D 112 padded
])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kv, s, d, dtype,
                                              window):
    rng = np.random.default_rng(s + window)
    q, k, v = (torch.tensor(rng.normal(size=(b, n, s, d)).astype(np.float32),
                            device=cuda).to(dtype) for n in (h, kv, kv))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    _assert_flash_held(got, want)


def _assert_flash_held(got, want):
    """1e-5, plus one bf16 ulp of the larger value for bfloat16."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    tol = torch.full_like(got, 1e-5)
    if bf16:
        big = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
        tol += torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("window", [0, 50])
def test_flash_attention_bf16_with_more_keys_than_queries(cuda, window):
    """Sk > Sq (causal positions from 0 on both axes, as the reference)."""
    rng = np.random.default_rng(7 + window)
    q, k, v = (torch.tensor(rng.normal(size=(2, n, s, 64)).astype(np.float32),
                            device=cuda).to(torch.bfloat16)
               for n, s in ((4, 300), (2, 700), (2, 700)))
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _assert_flash_held(got, want)


def test_flash_attention_bf16_reads_unaligned_views(cuda):
    """Views whose row starts are 2 bytes past a 16-byte boundary take the
    tensor-core kernel's element loads: equal to the result on contiguous
    copies (16-byte copies), bit for bit."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.normal(size=(2, n, 333, 72)).astype(
        np.float32), device=cuda).to(torch.bfloat16)[..., 1:65]
        for n in (6, 3, 3))
    assert q.data_ptr() % 16 != 0
    out = torch.empty((2, 6, 333, 72), dtype=torch.bfloat16,
                      device=cuda)[..., 1:65]
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=0, out=out)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, window=0)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert torch.equal(got, want)
    _assert_flash_held(got, fa.flash_attention_plain(q, k, v))


def test_attention_pallas_reads_model_layout_views(cuda):
    """Strided (B, S, H, D) views in, a (B, S, H, D) tensor out, equal to
    the kernel on contiguous copies (non-causal: all keys)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(2, 300, n, 64))
                            .astype(np.float32), device=cuda)
               for n in (6, 2, 2))
    got = attention_pallas(q, k, v, causal=False)
    want = fa.flash_attention(*(t.transpose(1, 2).contiguous()
                                for t in (q, k, v)), causal=False)
    torch.cuda.synchronize()
    assert got.is_contiguous()
    assert torch.equal(got, want.transpose(1, 2))


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 2, 8, 160, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        fa.flash_attention(x, x, x)
    y = torch.zeros(1, 2, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(y, y, y)
    z = torch.zeros(1, 2, 16, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(z, z, z)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen1.5-0.5b",
                                  "kimi-k2-1t-a32b", "llama4-scout-17b-a16e",
                                  "qwen2-vl-72b", "whisper-large-v3"])
def test_two_layer_model_with_flash_on_the_card_matches_the_cpu(cuda, arch):
    """K6 once per decoder layer (the audio encoder and the
    cross-attention run without it); the vlm patches and audio frames as
    `request_batch` draws them."""
    cfg = get_smoke_config(arch).replace(use_flash=True, attn_chunk=16)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0))
    p_gpu = tree.map(lambda t: t.to(cuda), p_cpu)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 100)).astype(np.int32))
    extras = request_batch(cfg, 2, 20)
    extras.pop("tokens")
    on = lambda d, dev: {k: v.to(dev) for k, v in d.items()}  # noqa: E731
    before = fa.flash_attention.launches
    with torch.no_grad():
        l_cpu, _ = forward(p_cpu, cfg, dict(extras, tokens=toks))
        l_gpu, _ = forward(p_gpu, cfg, on(dict(extras, tokens=toks), cuda))
    assert fa.flash_attention.launches == before + cfg.n_layers
    assert float((l_gpu.cpu() - l_cpu).abs().max()) <= 1e-4
    g_cpu = serve(p_cpu, cfg, prompts(cfg.vocab, 2, 20), 9,
                  **extras)["tokens"]
    g_gpu = serve(p_gpu, cfg, prompts(cfg.vocab, 2, 20, device=cuda), 9,
                  **on(extras, cuda))["tokens"]
    assert torch.equal(g_cpu, g_gpu.cpu())


def _scan_held(got, want):
    """Within 5e-6 of ``want``'s largest magnitude, plus one bf16 ulp of
    the larger value for bfloat16."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    tol = torch.full_like(got, 5e-6 * max(1.0, float(want.abs().max())))
    if bf16:
        big = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
        tol += torch.exp2(torch.floor(torch.log2(big)) - 7)
    err = (got - want).abs()
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("b,l,d,n,dtype", [
    (4, 2048, 8192, 16, torch.bfloat16),   # falcon-mamba-7b
    (3, 1000, 1000, 16, torch.float32),    # L and D not multiples of 32
    (2, 77, 45, 8, torch.bfloat16),
    (1, 33, 8, 4, torch.float32),          # N below 8 states a lane
])
def test_selective_scan_kernel_matches_plain(cuda, b, l, d, n, dtype):
    g = torch.Generator(cuda).manual_seed(l)
    x = torch.randn(b, l, d, generator=g, device=cuda).to(dtype)
    dt = (softplus(torch.randn(b, l, d, generator=g, device=cuda))
          * 0.1).to(dtype)
    Bm, Cm = (torch.randn(b, l, n, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    A = -torch.exp(torch.randn(d, n, generator=g, device=cuda) * 0.2)
    before = ss.selective_scan.launches
    y, h = ss.selective_scan(x, dt, Bm, Cm, A)
    yp, hp = ss.selective_scan_plain(x, dt, Bm, Cm, A)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    _scan_held(y, yp)
    _scan_held(h, hp)


@pytest.mark.parametrize("b,l,h,p,n,c,dtype", [
    (8, 2048, 64, 64, 64, 128, torch.bfloat16),  # zamba2-1.2b
    (2, 1000, 7, 64, 64, 128, torch.float32),    # ragged L, odd heads
    (1, 50, 6, 8, 32, 64, torch.bfloat16),       # chunk > L
    (1, 37, 3, 5, 7, 6, torch.float32),          # sizes not multiples of 4
])
def test_ssd_scan_kernel_matches_plain(cuda, b, l, h, p, n, c, dtype):
    g = torch.Generator(cuda).manual_seed(l)
    x = torch.randn(b, l, h, p, generator=g, device=cuda).to(dtype)
    dt = (softplus(torch.randn(b, l, h, generator=g, device=cuda))
          * 0.1).to(dtype)
    Bm, Cm = (torch.randn(b, l, n, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    A = -torch.exp(torch.randn(h, generator=g, device=cuda) * 0.3)
    before = sd.ssd_scan.launches
    y, hf = sd.ssd_scan(x, dt, Bm, Cm, A, chunk=c)
    yp, hp = sd.ssd_scan_plain(x, dt, Bm, Cm, A, chunk=c)
    torch.cuda.synchronize()
    assert sd.ssd_scan.launches == before + 1
    assert y.dtype == dtype and hf.dtype == torch.float32
    _scan_held(y, yp)
    _scan_held(hf, hp)


def test_ssd_scan_reads_the_models_strided_views(cuda):
    """x, B and C as views of one (B, L, conv_dim) tensor and dt as a
    column block of another, as `models.ssm` hands them over: equal to the
    kernel on contiguous copies."""
    g = torch.Generator(cuda).manual_seed(0)
    H, P, N, L = 4, 16, 8, 40
    xbc = torch.randn(2, L, H * P + 2 * N, generator=g, device=cuda)
    zdt = softplus(torch.randn(2, L, 3 * H, generator=g, device=cuda))
    x = xbc[..., :H * P].reshape(2, L, H, P)
    Bm = xbc[..., H * P:H * P + N].reshape(2, L, 1, N)
    Cm = xbc[..., H * P + N:].reshape(2, L, 1, N)
    dt = zdt[..., H:2 * H] * 0.1
    A = -torch.exp(torch.randn(H, generator=g, device=cuda))
    got = sd.ssd_scan(x, dt, Bm, Cm, A, chunk=16)
    want = sd.ssd_scan(x.contiguous(), dt.contiguous(),
                       Bm[:, :, 0].contiguous(), Cm[:, :, 0].contiguous(),
                       A, chunk=16)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _k7_args(dev, b, l, h, p, n, dtype, seed):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(b, l, h, p, generator=g, device=dev).to(dtype)
    dt = (softplus(torch.randn(b, l, h, generator=g, device=dev))
          * 0.1).to(dtype)
    Bm, Cm = (torch.randn(b, l, n, generator=g, device=dev).to(dtype)
              for _ in range(2))
    A = -torch.exp(torch.randn(h, generator=g, device=dev) * 0.5)
    return x, dt, Bm, Cm, A


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,l,h,p,n", [
    (2, 1, 7, 16, 16),          # one step
    (1, 127, 1, 64, 64),        # chunk - 1
    (2, 128, 7, 40, 40),        # one whole chunk; P, N not multiples of 16
    (1, 129, 64, 16, 64),       # chunk + 1
    (2, 1000, 7, 64, 16),       # ragged last chunk
    (1, 1000, 64, 40, 64),
    (1, 300, 1, 64, 40),
])
def test_ssd_scan_kernel_routes_match_plain_at_the_edges(cuda, b, l, h, p,
                                                         n, dtype):
    """Both routes (bf16 on the tensor cores, float32 on the CUDA cores) at
    chunk 128 around its edges, one and many heads, P and N at 16, 64 and
    40: within the phase-3 limits of the plain version."""
    args = _k7_args(cuda, b, l, h, p, n, dtype, seed=l + h + p)
    before = sd.ssd_scan.launches
    y, hf = sd.ssd_scan(*args, chunk=128)
    yp, hp = sd.ssd_scan_plain(*args, chunk=128)
    torch.cuda.synchronize()
    assert sd.ssd_scan.launches == before + 1
    assert y.dtype == dtype and hf.dtype == torch.float32
    _scan_held(y, yp)
    _scan_held(hf, hp)


@pytest.mark.parametrize("offset", [8, 3])
def test_ssd_scan_bf16_reads_the_models_strided_views(cuda, offset):
    """bf16 x, B and C as views of one (B, L, conv_dim) tensor and dt as a
    column block of another, as `models.ssm` hands them over, starting on a
    16-byte boundary (offset 8: 16-byte copies) or not (offset 3: element
    loads): equal to the kernel on contiguous copies, and within the limits
    of the plain version."""
    g = torch.Generator(cuda).manual_seed(offset)
    H, P, N, L = 4, 64, 64, 300
    xbc = torch.randn(2, L, offset + H * P + 2 * N + 5, generator=g,
                      device=cuda).to(torch.bfloat16)
    zdt = softplus(torch.randn(2, L, 3 * H, generator=g, device=cuda))
    x = xbc[..., offset:offset + H * P].reshape(2, L, H, P)
    Bm = xbc[..., offset + H * P:offset + H * P + N].reshape(2, L, 1, N)
    Cm = xbc[..., offset + H * P + N:offset + H * P + 2 * N] \
        .reshape(2, L, 1, N)
    dt = (zdt[..., H:2 * H] * 0.1).to(torch.bfloat16)
    A = -torch.exp(torch.randn(H, generator=g, device=cuda) * 0.5)
    got = sd.ssd_scan(x, dt, Bm, Cm, A, chunk=128)
    flat = (x.contiguous(), dt.contiguous(), Bm[:, :, 0].contiguous(),
            Cm[:, :, 0].contiguous(), A)
    want = sd.ssd_scan(*flat, chunk=128)
    plain = sd.ssd_scan_plain(*flat, chunk=128)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _scan_held(got[0], plain[0])
    _scan_held(got[1], plain[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 256])
@pytest.mark.parametrize("b,l,d", [(2, 1, 45), (2, 77, 70)])
def test_selective_scan_kernel_matches_plain_at_every_width(cuda, b, l, d, n,
                                                            dtype):
    """Every state width the lane layout takes, at a ragged D and at L = 1
    and L not a multiple of the 32-step tile."""
    g = torch.Generator(cuda).manual_seed(n + l)
    x = torch.randn(b, l, d, generator=g, device=cuda).to(dtype)
    dt = (softplus(torch.randn(b, l, d, generator=g, device=cuda))
          * 0.1).to(dtype)
    Bm, Cm = (torch.randn(b, l, n, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    A = -torch.exp(torch.randn(d, n, generator=g, device=cuda) * 0.5)
    y, h = ss.selective_scan(x, dt, Bm, Cm, A)
    yp, hp = ss.selective_scan_plain(x, dt, Bm, Cm, A)
    torch.cuda.synchronize()
    _scan_held(y, yp)
    _scan_held(h, hp)


def test_selective_scan_bf16_reads_unaligned_views(cuda):
    """bf16 rows that start on an odd element (element loads, not 4-byte
    copies) give the kernel's result on contiguous copies."""
    g = torch.Generator(cuda).manual_seed(5)
    b, l, d, n = 2, 100, 64, 16
    xd = torch.randn(b, l, 2 * d + 1, generator=g, device=cuda)
    xd[..., d + 1:] = softplus(xd[..., d + 1:]) * 0.1
    xd = xd.to(torch.bfloat16)
    bc = torch.randn(b, l, 2 * n + 1, generator=g,
                     device=cuda).to(torch.bfloat16)
    x, dt = xd[..., 1:d + 1], xd[..., d + 1:]
    Bm, Cm = bc[..., 1:n + 1], bc[..., n + 1:]
    A = -torch.exp(torch.randn(d, n, generator=g, device=cuda) * 0.5)
    got = ss.selective_scan(x, dt, Bm, Cm, A)
    want = ss.selective_scan(x.contiguous(), dt.contiguous(),
                             Bm.contiguous(), Cm.contiguous(), A)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_scan_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 8, 4, device=cuda)
    bc = torch.zeros(1, 8, 16, device=cuda)
    A = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ss.selective_scan(x.half(), x.half(), bc.half(), bc.half(), A)
    with pytest.raises(ValueError, match="power of two"):
        ss.selective_scan(x, x, bc[..., :12], bc[..., :12], A[:, :12])
    with pytest.raises(ValueError, match="contiguous"):
        ss.selective_scan(x, torch.zeros(1, 4, 8, device=cuda).transpose(1, 2),
                          bc, bc, A)
    with pytest.raises(ValueError, match="float32"):
        ss.selective_scan(x, x, bc, bc, A.double())
    wide = torch.zeros(1, 8, 512, device=cuda)
    with pytest.raises(ValueError, match="power of two"):
        ss.selective_scan(x, x, wide, wide, torch.zeros(4, 512, device=cuda))
    x4 = torch.zeros(1, 8, 2, 64, device=cuda)
    dt = torch.zeros(1, 8, 2, device=cuda)
    big = torch.zeros(1, 8, 256, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sd.ssd_scan(torch.zeros(1, 512, 2, 64, device=cuda),
                    torch.zeros(1, 512, 2, device=cuda),
                    torch.zeros(1, 512, 256, device=cuda),
                    torch.zeros(1, 512, 256, device=cuda),
                    torch.zeros(2, device=cuda), chunk=512)
    with pytest.raises(ValueError, match="bfloat16"):
        sd.ssd_scan(x4.half(), dt.half(), big[..., :8].half(),
                    big[..., :8].half(), torch.zeros(2, device=cuda), chunk=4)
    a2 = torch.zeros(2, device=cuda)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="P up to 64"):      # tensor cores
        sd.ssd_scan(torch.zeros(1, 8, 2, 72, device=cuda, dtype=bf),
                    dt.to(bf), big[..., :16].to(bf), big[..., :16].to(bf),
                    a2, chunk=4)
    with pytest.raises(ValueError, match="N up to 128"):
        sd.ssd_scan(x4.to(bf), dt.to(bf), big[..., :136].to(bf),
                    big[..., :136].to(bf), a2, chunk=4)
    with pytest.raises(ValueError, match="shared memory"):
        sd.ssd_scan(torch.zeros(1, 1024, 2, 64, device=cuda, dtype=bf),
                    torch.zeros(1, 1024, 2, device=cuda, dtype=bf),
                    torch.zeros(1, 1024, 128, device=cuda, dtype=bf),
                    torch.zeros(1, 1024, 128, device=cuda, dtype=bf),
                    a2, chunk=1024)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_two_layer_ssm_models_on_the_card_match_the_cpu(cuda, arch):
    """The smoke configs (float32; zamba2 with use_flash, so its shared
    block runs K6): logits within 1e-4, greedy tokens equal."""
    cfg = get_smoke_config(arch).replace(use_flash=True, attn_chunk=16)
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0))
    p_gpu = tree.map(lambda t: t.to(cuda), p_cpu)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 100)).astype(np.int32))
    before = fa.flash_attention.launches
    with torch.no_grad():
        l_cpu, _ = forward(p_cpu, cfg, {"tokens": toks})
        l_gpu, _ = forward(p_gpu, cfg, {"tokens": toks.to(cuda)})
    calls = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    assert fa.flash_attention.launches == before + calls
    assert float((l_gpu.cpu() - l_cpu).abs().max()) <= 1e-4
    g_cpu = serve(p_cpu, cfg, prompts(cfg.vocab, 2, 20), 9)["tokens"]
    g_gpu = serve(p_gpu, cfg, prompts(cfg.vocab, 2, 20, device=cuda),
                  9)["tokens"]
    assert torch.equal(g_cpu, g_gpu.cpu())


# ---------------------------------------------------------------------------
# observability and the simulation service on the card
# ---------------------------------------------------------------------------

def test_fence_waits_on_a_long_kernel(cuda):
    """`obs.fence` returns only after the work queued before it on the
    current stream has run (an event recorded behind that work has
    completed), and hands its argument back unchanged."""
    from repro_torch.obs import fence

    x = torch.randn(4096, 4096, device=cuda) / 64
    torch.cuda.synchronize()
    y = x
    for _ in range(20):                 # ~2.7 TFLOP of float32 matmuls
        y = y @ x
    behind = torch.cuda.Event()
    behind.record()
    assert not behind.query()
    nest = {"out": (y, [3.0, "host"])}
    assert fence(nest) is nest
    assert behind.query()


def _paper_async(n_nodes, rounds=1, sim=None):
    return api.ExperimentSpec(
        fleet=api.FleetSpec(n_nodes=n_nodes, model="cnn", hw=(28, 28),
                            samples_per_node=60,
                            attack=api.AttackMix(malicious_frac=0.3,
                                                 flip_src=1, flip_dst=7)),
        schedule=api.SchedulePolicy(kind="async"),
        privacy=api.PrivacySpec(sigma=0.05),
        compression=api.CompressionSpec(sparsify_ratio=0.1),
        defense=api.DefenseSpec(detect=True, detect_s=80.0),
        network=api.NetworkSpec(codec="sparse_bitpack", bandwidth_sigma=1.0,
                                latency_s=0.02, jitter_s=0.1,
                                loss_prob=0.2),
        topology=api.Topology(backend="pallas"),
        train=api.TrainSpec(local_steps=5, batch_size=16, lr=0.1),
        rounds=rounds, seed=0, sim=sim)


def _bitwise(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


def test_traced_1000_node_window_is_bitwise_the_untraced_one(cuda):
    from repro_torch import obs

    spec = _paper_async(1000)
    plan = api.compile_plan(spec)
    pop = api.materialize(spec, device="cuda")
    sink = obs.MemorySink()
    tracer = obs.Tracer(sinks=[sink], stage_timings=True)
    got = []
    for tr in (obs.Tracer(enabled=False), tracer):
        with obs.use_tracer(tr):
            eng = api.make_engine(plan, pop, device="cuda")
            rec = eng.run_window()
        got.append((rec, eng.params, eng.state.next_arrival.clone(),
                    eng.state.acc_ring.clone()))
    (r0, p0, a0, g0), (r1, p1, a1, g1) = got
    assert r1 == r0 and _bitwise(p0, p1)
    assert torch.equal(a0, a1) and torch.equal(g0.isnan(), g1.isnan())
    assert torch.equal(g0.nan_to_num(), g1.nan_to_num())
    names = {e.name for e in sink.events}
    assert {"window", "arrival", "detect.verdict", "net.upload",
            "stage.window.device"} <= names
    verdicts = [e for e in sink.events if e.name == "detect.verdict"]
    assert sum(e.tags["rejected"] for e in verdicts) == r1.n_rejected
    assert len(verdicts) == r1.n_processed


def _small_sim():
    return _paper_async(16, rounds=4, sim=api.SimSpec(
        traces=(api.TrafficTrace(kind="diurnal", period_s=2.0,
                                 amplitude=0.5),),
        events=(api.SimEvent(at_round=2, kind="attack", payload={
            "kind": "label_flip", "malicious_frac": 0.5}),)))


def test_resume_on_the_card_is_bitwise_the_uninterrupted_run(cuda,
                                                             tmp_path):
    from repro_torch.sim import SimService

    plan = api.compile_plan(_small_sim())
    base = SimService(plan, device="cuda").run()
    for kill in (1, 3):
        svc = SimService(plan, device="cuda")
        svc.run(max_records=kill)
        path = svc.checkpoint(str(tmp_path / f"ck{kill}"))
        del svc
        rep = SimService.resume(path, device="cuda").run()
        assert rep.records == base.records and rep.net == base.net
        assert rep.epsilon_spent == base.epsilon_spent
        assert _bitwise(rep.final_params, base.final_params)


def test_card_checkpoint_restores_on_the_cpu_with_equal_arrays(cuda,
                                                               tmp_path):
    from repro_torch.sim import SimService

    svc = SimService(api.compile_plan(_small_sim()), device="cuda")
    svc.run(max_records=3)
    path = svc.checkpoint(str(tmp_path / "ck"))
    want, want_meta = svc.stepper.export_state()
    cpu = SimService.resume(path, device="cpu")
    got, got_meta = cpu.stepper.export_state()
    assert got_meta == want_meta
    assert cpu.state.params["fc"]["w"].device.type == "cpu"
    flat_w, flat_g = _flat(want), _flat(got)
    assert sorted(flat_w) == sorted(flat_g)
    for k in flat_w:
        a, b = np.asarray(flat_w[k]), np.asarray(flat_g[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def _flat(t, prefix=""):
    if isinstance(t, dict):
        out = {}
        for k in t:
            out.update(_flat(t[k], f"{prefix}/{k}"))
        return out
    return {prefix: t}


# ---------------------------------------------------------------------------
# LLM training: the paper's round on the card
# ---------------------------------------------------------------------------

def _tiny_lm(**kw):
    return get_smoke_config("qwen1.5-0.5b").replace(
        n_layers=2, d_model=64, d_ff=128, vocab=64, attn_chunk=8, **kw)


def _lm_batches(cfg, lead, seed):
    from repro_torch.data import make_token_dataset
    from repro_torch.launch.train import make_batches

    data = make_token_dataset(0, 128, 16, cfg.vocab)
    return make_batches(cfg, data, lead, 16, np.random.default_rng(seed))


def test_tiny_fed_round_on_the_card_matches_the_cpu(cuda):
    """One `fed_train_step` (4 nodes x 2 local steps, σ 1e-3, Alg. 2 at
    s = 50) on the card and on the CPU from the same params and batches:
    params within 1e-6 (the CPU tests hold the port to the reference
    there), accuracies, the mask and n_normal equal; the node's noise is
    the same threefry chain on both devices.  A second card run repeats
    the first bit for bit (`device.deterministic`)."""
    from repro_torch.core.fed_step import FedStepConfig
    from repro_torch.launch.steps import make_step

    cfg = _tiny_lm(remat=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    nb, eb = _lm_batches(cfg, (4, 2, 4), 0), _lm_batches(cfg, (4,), 1)
    step = make_step(cfg, "fed_train", fcfg=FedStepConfig(
        n_nodes=4, local_steps=2, lr=0.5, sigma=1e-3, detect_s=50.0))
    key = np.array([0, 7], np.uint32)
    out = {}
    for dev in ("cpu", "cuda", "cuda"):
        to = lambda t: tree.map(lambda x: x.to(dev), t)  # noqa: E731
        p, m = step(to(params), to(nb), to(eb), key)
        if dev in out:
            for a, b in zip(tree.leaves(p), tree.leaves(out[dev][0])):
                assert torch.equal(a, b)
        out[dev] = (p, m)
    (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
    for a, b in zip(tree.leaves(pg), tree.leaves(pc)):
        assert float((a.cpu() - b).abs().max()) <= 1e-6
    for k in ("node_accuracies", "n_normal", "detect_threshold"):
        assert torch.equal(mg[k].cpu(), mc[k]), k


def test_use_flash_training_raises_on_the_card(cuda):
    from repro_torch.launch.steps import make_step

    cfg = _tiny_lm(use_flash=True)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    batch = tree.map(lambda x: x.cuda(), _lm_batches(cfg, (2,), 0))
    fa.flash_attention.launches = 0
    with pytest.raises(RuntimeError, match="K6.*no backward kernel"):
        make_step(cfg, "plain_train")(params, batch)
    assert fa.flash_attention.launches == 0


def test_tree_noise_runs_in_bounded_memory(cuda):
    """`core.aldp.add_gaussian_noise` over one 10^8-element float32 leaf
    holds the output and one chunk's chain (about 155 bytes a counter,
    0.65 GB at 2^22 counters), not the whole leaf's int64 and float64
    temporaries (more than 8 GB): peak above the input within the output
    plus 2 GB.  The first and last chunks' draws equal the same counters
    drawn alone."""
    from repro_torch import prng
    from repro_torch.core import aldp

    n = 100_000_000
    x = torch.zeros(n, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    key = np.array([3, 9], np.uint32)
    out = aldp.add_gaussian_noise({"w": x}, key, 0.5, 1.0)["w"]
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= 4 * n + 2 * 2**30, extra
    k1, k2 = (torch.tensor(int(w), dtype=torch.int64, device="cuda")
              for w in prng.split(key, 1)[0])
    c = prng.normal_scale(0.5)
    for lo, hi in ((0, 1000), (n - 1000, n)):
        cnt = torch.arange(lo, hi, dtype=torch.int64, device="cuda")
        z = prng.erf_inv_draws(prng.bits_tensor(k1, k2, cnt))
        assert torch.equal(out[lo:hi], z * float(c))
