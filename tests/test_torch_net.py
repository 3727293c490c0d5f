"""The port's network layer (`repro_torch.net`) against `repro.net`.

The same numpy inputs go through both packages.  Tolerances: none — the
codecs' payloads are byte-identical, their decodes and closed-form sizes
equal; the link draws and `NetSim` traces are bit-identical (both are
the same numpy float64 / uint64 arithmetic); the batched byte accounting
is equal on both backends (K3's plain version on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import net as jnet
from repro_torch import net as tnet

NNZ_ROWS = (0, 1, 50, 1500, 3000)
CODECS = [("dense_f32", 32), ("sparse_coo", 32), ("sparse_bitpack", 32),
          ("sparse_bitpack", 16), ("sparse_bitpack", 8)]


def _sparse_update(n_params, nnz, seed=0):
    rng = np.random.default_rng(seed)
    u = np.zeros(n_params, np.float32)
    if nnz:
        idx = rng.choice(n_params, nnz, replace=False)
        u[idx] = rng.normal(size=nnz).astype(np.float32)
    return u


@pytest.mark.parametrize("name,value_bits", CODECS)
def test_codec_payloads_are_byte_identical(name, value_bits):
    jc = jnet.get_codec(name, value_bits=value_bits)
    tc = tnet.get_codec(name, value_bits=value_bits)
    assert tc.describe() == jc.describe()
    for nnz in NNZ_ROWS:
        u = _sparse_update(3000, nnz, seed=nnz)
        jm, tm = jc.encode(u), tc.encode(u)
        assert tm.payload == jm.payload
        assert (tm.codec, tm.n_params, tm.meta) == \
            (jm.codec, jm.n_params, jm.meta)
        assert tm.nbytes == jm.nbytes == int(tc.nbytes(nnz, u.size))
        np.testing.assert_array_equal(tc.decode(tm), jc.decode(jm))
    counts = np.asarray(NNZ_ROWS)
    np.testing.assert_array_equal(tc.nbytes(counts, 3000),
                                  jc.nbytes(counts, 3000))


@pytest.mark.parametrize("name,value_bits", [("zstd", 32),
                                             ("dense_f32", 8),
                                             ("sparse_coo", 16),
                                             ("sparse_bitpack", 12)])
def test_bad_codecs_raise_the_same_value_error(name, value_bits):
    with pytest.raises(ValueError) as ej:
        jnet.get_codec(name, value_bits=value_bits)
    with pytest.raises(ValueError) as et:
        tnet.get_codec(name, value_bits=value_bits)
    assert str(et.value) == str(ej.value)


def test_index_bits_and_analytic_bytes():
    for n in (1, 2, 3, 1024, 1025, 20490):
        assert tnet.index_bits(n) == jnet.index_bits(n)
    for n, r in ((20490, 0.1), (20490, 1.0), (1000, 0.05)):
        assert tnet.analytic_upload_bytes(n, r) == \
            jnet.analytic_upload_bytes(n, r)
    with pytest.raises(ValueError):
        tnet.index_bits(0)


LINKS = [
    dict(bandwidth_sigma=1.0, latency_s=0.02, jitter_s=0.1, loss_prob=0.2),
    dict(jitter_s=2.0, loss_prob=0.3, mtu_bytes=512,
         shared_uplink_bps=25e6),
    dict(latency_s=0.05, loss_prob=0.05),
]


@pytest.mark.parametrize("case", range(len(LINKS)))
@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_link_draws_are_bit_identical(case, seed):
    kw = LINKS[case]
    rng = np.random.default_rng(seed % 1000)
    base = rng.uniform(1e6, 2e7, 40)
    jb = jnet.materialize_bandwidth(base, kw.get("bandwidth_sigma", 0.0),
                                    seed)
    tb = tnet.materialize_bandwidth(base, kw.get("bandwidth_sigma", 0.0),
                                    seed)
    np.testing.assert_array_equal(tb, jb)
    nodes = rng.integers(0, 40, 25)
    seqs = rng.integers(0, 1000, 25)
    for payload in (4, 9000, 110_000):
        jout = jnet.draw_transfer_batch(jnet.LinkProfile(**kw), payload,
                                        jb[nodes], seed, nodes, seqs,
                                        concurrency=25)
        tout = tnet.draw_transfer_batch(tnet.LinkProfile(**kw), payload,
                                        tb[nodes], seed, nodes, seqs,
                                        concurrency=25)
        for a, b in zip(jout, tout):
            np.testing.assert_array_equal(b, a)
    assert tnet.draw_transfer(tnet.LinkProfile(**kw), 9000, 1e7, seed, 3,
                              5) == \
        jnet.draw_transfer(jnet.LinkProfile(**kw), 9000, 1e7, seed, 3, 5)


def test_link_profile_validation_matches():
    for bad in (dict(loss_prob=1.0), dict(mtu_bytes=0),
                dict(latency_s=-1.0), dict(bandwidth_sigma=-0.1),
                dict(shared_uplink_bps=-1.0)):
        with pytest.raises(ValueError) as ej:
            jnet.LinkProfile(**bad).validate()
        with pytest.raises(ValueError) as et:
            tnet.LinkProfile(**bad).validate()
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError) as ej:
        jnet.materialize_bandwidth(np.array([1.0, 0.0]), 0.0, 0)
    with pytest.raises(ValueError) as et:
        tnet.materialize_bandwidth(np.array([1.0, 0.0]), 0.0, 0)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("codec,link", [
    ("sparse_bitpack", LINKS[0]), ("sparse_coo", LINKS[1]),
    ("dense_f32", dict(latency_s=0.02, shared_uplink_bps=25e6))])
def test_netsim_draw_commit_sequence_is_identical(codec, link):
    n_nodes, n_params = 12, 20490
    bw = np.random.default_rng(1).uniform(5e6, 2e7, n_nodes)
    jsim = jnet.NetSim(codec, jnet.LinkProfile(**link), bw, n_params,
                       sparsify_ratio=0.1, seed=5)
    tsim = tnet.NetSim(codec, tnet.LinkProfile(**link), bw, n_params,
                       sparsify_ratio=0.1, seed=5)
    assert tsim.nominal_payload_bytes == jsim.nominal_payload_bytes
    rng = np.random.default_rng(2)
    for _ in range(5):
        nodes = rng.choice(n_nodes, rng.integers(1, n_nodes), replace=False)
        nnz = rng.integers(0, n_params, nodes.size)
        extra = int(rng.integers(0, 4))     # flood flows on the uplink
        jd = jsim.draw(nodes, extra_concurrency=extra)
        td = tsim.draw(nodes, extra_concurrency=extra)
        for f in ("nodes", "seqs", "transfer_s", "overhead_bytes",
                  "retransmits"):
            np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
        np.testing.assert_array_equal(tsim.commit(td, nnz),
                                      jsim.commit(jd, nnz))
    for f in ("nodes", "seqs", "nnz", "encoded_bytes", "wire_bytes",
              "transfer_s", "retransmits"):
        assert getattr(tsim.trace, f) == getattr(jsim.trace, f)
    assert tsim.summary() == jsim.summary()
    with pytest.raises(ValueError, match="commit"):
        tsim.commit(tsim.draw(np.arange(3)), np.zeros(2))


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("name,value_bits", CODECS)
def test_batched_encoded_bytes_matches_reference(backend, name,
                                                 value_bits):
    rows = np.stack([_sparse_update(3000, k, seed=k) for k in NNZ_ROWS])
    rows[1, 7] = -0.0                   # signed zero: not counted
    rows[2, 9] = np.nan                 # NaN: counted
    jc = jnet.get_codec(name, value_bits=value_bits)
    tc = tnet.get_codec(name, value_bits=value_bits)
    ref = jnet.batched_encoded_bytes(jnp.asarray(rows), jc, backend=backend)
    out = tnet.batched_encoded_bytes(torch.tensor(rows), tc, backend=backend)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        tnet.count_nnz(rows, backend).numpy(),
        np.asarray(jnet.count_nnz(jnp.asarray(rows), backend)))


def test_netsim_from_network_follows_the_spec():
    from repro import api as japi
    from repro_torch import api as tapi
    assert tnet.netsim_from_network(tapi.NetworkSpec(), np.ones(3), 10,
                                    1.0, 0) is None
    kw = dict(codec="sparse_bitpack", value_bits=16, bandwidth_sigma=0.5,
              latency_s=0.01, jitter_s=0.2, loss_prob=0.1, mtu_bytes=700,
              shared_uplink_bps=3e6)
    bw = np.full(6, 1e7)
    js = jnet.netsim_from_network(japi.NetworkSpec(**kw), bw, 5000, 0.2, 3)
    ts = tnet.netsim_from_network(tapi.NetworkSpec(**kw), bw, 5000, 0.2, 3)
    assert ts.codec.describe() == js.codec.describe()
    assert ts.link == tnet.LinkProfile(**{k: v for k, v in kw.items()
                                          if k not in ("codec",
                                                       "value_bits")})
    np.testing.assert_array_equal(ts.eff_bandwidth_bps, js.eff_bandwidth_bps)
    assert ts.nominal_payload_bytes == js.nominal_payload_bytes
    assert ts.rate_scale is None
