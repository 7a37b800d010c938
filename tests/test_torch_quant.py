"""The port's ``quant`` (``src/repro_torch/quant.py``) against the
reference's ``src/repro/quant.py``.

* The reference's seven cases (``tests/test_quant.py``) run on both
  packages: per-block round-trip bounds, the device functions against
  their numpy twins, all-zero blocks, transcodes, the per-tensor helpers,
  the byte accounting and the spec lookup. On the port the device
  quantize equals its numpy twin bit for bit, scales included; the
  reference's jnp path keeps its own bar (identical bytes, scales within
  ``rtol=2e-7``: XLA lowers the divide to a reciprocal multiply).
* Across packages, on the same inputs: the port's device quantize is
  bit-equal to the reference's ``quantize_blocks_np`` (int8 and fp8, f32
  and bf16 sources; fp8 compared through ``uint8`` views) and within the
  reference's own bar of its jnp path; ``transcode_tree_np`` gives equal
  bytes; ``quant_chain_block_nbytes`` is equal on qwen2-7b smoke and on
  the full qwen2-7b template (917,504 B lossless, 458,976 B int8 with
  bt=16).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro import quant as rq  # noqa: E402
from repro.models import init_decode_cache  # noqa: E402
from repro.serve.kv_pool import \
    quant_chain_block_nbytes as jax_quant_nbytes  # noqa: E402
from repro.train import compression  # noqa: E402
from repro_torch.train import compression as port_compression  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import quant as pq  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.lm import cache_shapes  # noqa: E402
from repro_torch.serve.kv_pool import quant_chain_block_nbytes  # noqa: E402

SHAPES = [(5, 4, 2, 6), (3, 2, 8, 1, 4), (2, 3, 2, 4, 2, 8)]
DTYPES = ["float32", "bfloat16"]
SPEC_NAMES = ["int8", "fp8"]


def _bits(a) -> np.ndarray:
    """The bytes of a host array of either package (bf16, fp8 or their
    storage integers alike), as unsigned integers of the same width."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _jax_array(x, dtype):
    return jnp.asarray(x, jnp.dtype(dtype))


def _port_array(x, dtype):
    """The tensor holding the reference's input bits (``jnp.asarray``'s
    rounding of the same values)."""
    bits = _bits(_jax_array(x, dtype)).copy()
    return pq.from_host(bits.view(pq.storage_dtype(getattr(torch, dtype))))


REF = SimpleNamespace(
    name="ref", q=rq, array=_jax_array,
    f32=lambda a: np.asarray(a, np.float32),
    deq_f32=lambda q, s: rq.dequantize_rows(q, s, dtype=jnp.float32),
    qdtype=lambda spec: jnp.dtype(spec.dtype), f32dtype=jnp.float32,
    bf16=jnp.bfloat16, compression=compression)
PORT = SimpleNamespace(
    name="port", q=pq, array=_port_array,
    f32=lambda a: a.to(torch.float32).numpy(),
    deq_f32=lambda q, s: pq.dequantize_rows(
        q, s if isinstance(s, torch.Tensor) else torch.from_numpy(s),
        dtype=torch.float32),
    qdtype=lambda spec: spec.dtype, f32dtype=torch.float32,
    bf16=torch.bfloat16, compression=port_compression)
PKGS = [REF, PORT]
pkg_param = pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
spec_param = pytest.mark.parametrize("spec_name", SPEC_NAMES)


def _blocks_np(shape, seed):
    rng = np.random.default_rng(seed)
    # per-block magnitude spread across orders of magnitude: the bound is
    # relative to each block's own amax, so scales must actually differ
    return rng.standard_normal(shape) * (10.0 ** rng.uniform(
        -3, 2, (shape[0],) + (1,) * (len(shape) - 1)))


def _blocks(pkg, shape, dtype, seed):
    return pkg.array(_blocks_np(shape, seed), dtype)


# ---------------------------------------------------------------------------
# the reference's seven cases, on both packages
# ---------------------------------------------------------------------------

@pkg_param
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@spec_param
def test_round_trip_error_bound(pkg, spec_name, shape, dtype):
    """|x - deq(quant(x))| <= spec.rt_bound * amax(block), element-wise,
    for every block of every (format, layout, source dtype)."""
    spec = pkg.q.SPECS[spec_name]
    x = _blocks(pkg, shape, dtype,
                seed=hash((spec_name, shape, dtype)) & 0xFFFF)
    q, scales = pkg.q.quantize_rows(x, spec=spec)
    assert tuple(q.shape) == tuple(x.shape)
    assert q.dtype == pkg.qdtype(spec)
    assert tuple(scales.shape) == tuple(x.shape[:-3])
    assert scales.dtype == pkg.f32dtype
    rt = pkg.f32(pkg.deq_f32(q, scales))
    xf = pkg.f32(x)
    amax = np.max(np.abs(xf), axis=(-3, -2, -1), keepdims=True)
    err = np.abs(xf - rt)
    # 1% slack over the exact half-step bound: coarse (bf16) values land
    # on rounding ties, and the f32 divide/multiply add a few ulps
    assert np.all(err <= spec.rt_bound * amax * 1.01 + 1e-9), \
        f"max rel err {np.max(err / np.maximum(amax, 1e-12)):.5f}"


@pkg_param
@spec_param
def test_numpy_twins_match_device_functions(pkg, spec_name):
    """Host/disk transcodes (numpy) and the device functions are the same
    math: identical stored bytes; the reference's scales agree to 1 ulp
    (XLA lowers the divide to a reciprocal multiply), the port's bit for
    bit (a true division on both sides)."""
    spec = pkg.q.SPECS[spec_name]
    x = _blocks(pkg, SHAPES[1], "float32", seed=7)
    qd, sd = pkg.q.quantize_rows(x, spec=spec)
    qn, sn = pkg.q.quantize_blocks_np(np.asarray(pkg.f32(x)), spec)
    if pkg is PORT:
        qd, sd = pq.to_host(qd), sd.numpy()
        np.testing.assert_array_equal(sd, sn)
    np.testing.assert_array_equal(_bits(qd), _bits(qn))
    np.testing.assert_allclose(np.asarray(sd), sn, rtol=2e-7)
    qdev, _ = pkg.q.quantize_rows(x, spec=spec)
    dd = pkg.f32(pkg.deq_f32(qdev, sn))
    dn = pkg.q.dequantize_blocks_np(qn, sn, np.float32)
    np.testing.assert_array_equal(dd, dn)


@pkg_param
@spec_param
def test_all_zero_block_round_trips_exactly(pkg, spec_name):
    spec = pkg.q.SPECS[spec_name]
    x = pkg.array(np.zeros((2, 3, 4, 2, 2)), "float32")
    q, s = pkg.q.quantize_rows(x, spec=spec)
    host = pq.to_host(q) if pkg is PORT else np.asarray(q)
    assert not np.any(host.view(np.uint8))
    np.testing.assert_array_equal(pkg.f32(pkg.deq_f32(q, s)), 0.0)


@pkg_param
def test_transcode_identity_and_cross_format(pkg):
    q_mod = pkg.q
    x = {"k": _blocks_np(SHAPES[0], 11).astype(np.float32),
         "v": _blocks_np(SHAPES[0], 12).astype(np.float32)}
    q = {k: q_mod.quantize_blocks_np(b, q_mod.INT8)[0] for k, b in x.items()}
    s = {k: q_mod.quantize_blocks_np(b, q_mod.INT8)[1] for k, b in x.items()}
    # same format: the identity, arrays untouched
    q2, s2 = q_mod.transcode_tree_np(q, s, q_mod.INT8, q_mod.INT8)
    assert q2 is q and s2 is s
    # int8 -> fp8: within the sum of both formats' bounds of the original
    q3, s3 = q_mod.transcode_tree_np(q, s, q_mod.INT8, q_mod.FP8)
    for leaf in q3.values():
        assert leaf.dtype == (q_mod.FP8.storage if pkg is PORT
                              else q_mod.FP8.dtype)
    rt = {k: q_mod.dequantize_blocks_np(q3[k], s3[k], np.float32)
          for k in q3}
    bound = q_mod.INT8.rt_bound + q_mod.FP8.rt_bound
    for k in x:
        amax = np.max(np.abs(x[k]), axis=(-3, -2, -1), keepdims=True)
        assert np.all(np.abs(x[k] - rt[k]) <= bound * amax + 1e-9)
    # quantized -> lossless: widens to f32, no scales
    w, sw = q_mod.transcode_tree_np(q, s, q_mod.INT8, None)
    assert sw is None
    for leaf in w.values():
        assert leaf.dtype == np.float32
    # lossless -> quantized matches quantizing the source directly
    q4, s4 = q_mod.transcode_tree_np(x, None, None, q_mod.INT8)
    for k in x:
        qd, sd = q_mod.quantize_blocks_np(x[k], q_mod.INT8)
        np.testing.assert_array_equal(q4[k], qd)
        np.testing.assert_array_equal(s4[k], sd)


@pkg_param
def test_per_tensor_matches_historical_gradient_numerics(pkg):
    """quantize_tensor/dequantize_tensor: amax/127 symmetric int8 with the
    1e-12 floor, bit for bit."""
    rng = np.random.default_rng(3)
    for x in (rng.standard_normal((64, 7)).astype(np.float32) * 0.03,
              np.zeros((5, 5), np.float32)):
        xin = jnp.asarray(x) if pkg is REF else torch.from_numpy(x)
        q, s = pkg.q.quantize_tensor(xin)
        amax = np.max(np.abs(x))
        scale = np.maximum(amax, 1e-12) / 127.0
        q_ref = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(np.asarray(q), q_ref)
        assert float(s) == pytest.approx(scale, rel=1e-6)
        np.testing.assert_array_equal(
            np.asarray(pkg.q.dequantize_tensor(q, s)),
            q_ref.astype(np.float32) * np.float32(scale))


@pkg_param
def test_compression_ratio_prices_scales_and_source_dtype(pkg):
    q_mod = pkg.q
    # exact small-block accounting: 64 f32 elements + one f32 scale
    assert q_mod.compression_ratio(64, np.float32) == \
        pytest.approx(256 / 68)
    # bf16 sources compress 2x-ish, not the 4x a f32-only formula claims
    assert q_mod.compression_ratio(64, pkg.bf16) == pytest.approx(128 / 68)
    # scale overhead washes out at tensor scale
    assert q_mod.compression_ratio(1 << 20, np.float32) == \
        pytest.approx(4.0, rel=1e-4)
    assert q_mod.compression_ratio(64, np.float32, None) == 1.0
    assert q_mod.compression_ratio(64, pkg.f32dtype) == \
        q_mod.compression_ratio(64, np.float32)
    # train reports through the same formula
    assert pkg.compression.compression_ratio(pkg.f32dtype) == \
        pytest.approx(4.0)
    assert pkg.compression.compression_ratio(pkg.f32dtype, numel=64) == \
        pytest.approx(q_mod.compression_ratio(64, np.float32))
    assert pkg.compression.compression_ratio(pkg.bf16) == \
        pytest.approx(2.0)


@pkg_param
def test_get_spec_resolution(pkg):
    q_mod = pkg.q
    assert q_mod.get_spec(None) is None
    assert q_mod.get_spec("none") is None
    assert q_mod.get_spec("INT8") is q_mod.INT8
    assert q_mod.get_spec(q_mod.FP8) is q_mod.FP8
    with pytest.raises(ValueError):
        q_mod.get_spec("int4")
    assert q_mod.INT8.itemsize == q_mod.FP8.itemsize == 1


# ---------------------------------------------------------------------------
# across packages, on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@spec_param
def test_port_device_quantize_is_reference_numpy_twin_bit_for_bit(
        spec_name, shape, dtype):
    """The port's device quantize (here on CPU tensors) gives the
    reference's ``quantize_blocks_np`` bytes and scales bit for bit, and
    the reference's jnp path within the reference's own bar; the port's
    numpy twin and dequantizes equal the reference's."""
    rspec, pspec = rq.SPECS[spec_name], pq.SPECS[spec_name]
    x = _blocks_np(shape, seed=10 * SHAPES.index(shape)
                   + SPEC_NAMES.index(spec_name))
    xj, xt = _jax_array(x, dtype), _port_array(x, dtype)
    want_q, want_s = rq.quantize_blocks_np(np.asarray(xj), rspec)
    got_q, got_s = pq.quantize_blocks(xt, pspec)
    np.testing.assert_array_equal(_bits(pq.to_host(got_q)), _bits(want_q))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # the reference's jnp path: scales within its own bar; its bytes are
    # numpy's wherever its reciprocal multiply lands on numpy's side of a
    # rounding tie (see the next test for the one input where it does not)
    jq, js = rq.quantize_rows(xj, spec=rspec)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(js), rtol=2e-7)
    same = _bits(jq) == _bits(want_q)
    np.testing.assert_array_equal(_bits(pq.to_host(got_q))[same],
                                  _bits(jq)[same])
    np_q, np_s = pq.quantize_blocks_np(pq.to_host(xt), pspec)
    np.testing.assert_array_equal(_bits(np_q), _bits(want_q))
    np.testing.assert_array_equal(np_s, want_s)
    for rdt, pdt in ((np.float32, np.float32),
                     (ml_dtypes.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            _bits(pq.dequantize_blocks_np(np_q, np_s, pdt)),
            _bits(rq.dequantize_blocks_np(want_q, want_s, rdt)))
    np.testing.assert_array_equal(
        _bits(pq.to_host(pq.dequantize_blocks(got_q, got_s,
                                              torch.bfloat16))),
        _bits(rq.dequantize_blocks_np(want_q, want_s, ml_dtypes.bfloat16)))


@spec_param
def test_port_device_quantize_equals_reference_jnp_bytes(spec_name):
    """On the reference test's own input (f32, its second layout, seed 7)
    the reference's jnp path and its numpy twin store the same bytes; the
    port's device quantize stores those bytes too, with scales within
    ``rtol=2e-7`` of jnp's."""
    rspec, pspec = rq.SPECS[spec_name], pq.SPECS[spec_name]
    x = _blocks_np(SHAPES[1], seed=7)
    jq, js = rq.quantize_rows(_jax_array(x, "float32"), spec=rspec)
    got_q, got_s = pq.quantize_blocks(_port_array(x, "float32"), pspec)
    np.testing.assert_array_equal(_bits(pq.to_host(got_q)), _bits(jq))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(js), rtol=2e-7)


def test_reference_jnp_fp8_parts_from_its_numpy_twin_on_a_tie():
    """An observation about the reference: XLA lowers ``x / scale`` to a
    reciprocal multiply, whose scale here is one f32 ulp above numpy's
    (0.10156251 against 0.1015625). Where numpy's quotient is an exact
    fp8 rounding tie (76.0, between 72 and 80) jnp's lands just short of
    it: on fp8 with bf16 input (the third layout, seed 17) one byte of 768
    differs, 105 (jnp) against 106 (numpy). bf16 inputs have few mantissa
    bits, so such ties are common (10 of the first 34 seeds). The port
    divides, as numpy does, and stores 106."""
    x = _blocks_np(SHAPES[2], seed=17)
    xj = _jax_array(x, "bfloat16")
    nq, ns = rq.quantize_blocks_np(np.asarray(xj), rq.FP8)
    jq, js = rq.quantize_rows(xj, spec=rq.FP8)
    got_q, got_s = pq.quantize_blocks(_port_array(x, "bfloat16"), pq.FP8)
    diff = np.argwhere(_bits(jq) != _bits(nq))
    assert len(diff) == 1
    i = tuple(diff[0])
    assert (_bits(jq)[i], _bits(nq)[i], _bits(pq.to_host(got_q))[i]) == \
        (105, 106, 106)
    assert np.asarray(xj, np.float32)[i] / ns[i[:-3]] == 76.0
    assert np.asarray(js)[i[:-3]] == np.nextafter(ns[i[:-3]], np.inf)
    assert got_s.numpy()[i[:-3]] == ns[i[:-3]]


@pytest.mark.parametrize("src,dst", [(None, "int8"), (None, "fp8"),
                                     ("int8", "fp8"), ("fp8", "int8"),
                                     ("int8", None)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_transcode_tree_np_equal_across_packages(src, dst, dtype):
    """A host→disk transcode of the same stored rows gives the same bytes
    and scales in both packages (a bf16 source read from its ``uint16``
    host storage in the port)."""
    x = {"k": _blocks_np(SHAPES[2], 21), "v": _blocks_np(SHAPES[2], 22)}
    rs, ps = rq.get_spec(src), pq.get_spec(src)
    rsrc = {k: np.asarray(_jax_array(a, dtype)) for k, a in x.items()}
    psrc = {k: pq.to_host(_port_array(a, dtype)) for k, a in x.items()}
    if src is None:
        rblocks, rscales, pblocks, pscales = rsrc, None, psrc, None
    else:
        rblocks = {k: rq.quantize_blocks_np(a, rs)[0] for k, a in rsrc.items()}
        rscales = {k: rq.quantize_blocks_np(a, rs)[1] for k, a in rsrc.items()}
        pblocks = {k: pq.quantize_blocks_np(a, ps)[0] for k, a in psrc.items()}
        pscales = {k: pq.quantize_blocks_np(a, ps)[1] for k, a in psrc.items()}
    rq_out, rs_out = rq.transcode_tree_np(rblocks, rscales, rs,
                                          rq.get_spec(dst))
    pq_out, ps_out = pq.transcode_tree_np(pblocks, pscales, ps,
                                          pq.get_spec(dst))
    for k in x:
        np.testing.assert_array_equal(_bits(pq_out[k]), _bits(rq_out[k]))
        if dst is None:
            assert rs_out is None and ps_out is None
        else:
            np.testing.assert_array_equal(ps_out[k], rs_out[k])


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_quant_chain_block_nbytes_equal_across_packages(smoke):
    """The bytes a lossless, an int8 and an fp8 chain block cost, from the
    reference's real cache template and the port's meta-tensor one; on
    the full qwen2-7b at bt=16: 2 leaves x 28 x 16 x 4 x 128 x 2 B =
    917,504 B lossless, 458,752 B of payload + 224 B of scales int8."""
    jcfg = jax_configs.get("qwen2_7b", smoke=smoke)
    tcfg = configs.get("qwen2_7b", smoke=smoke)
    jtemplate = init_decode_cache(jcfg, 1, 8)
    ttemplate = tree_map(
        lambda s: torch.empty(s, dtype=tcfg.dtype, device="meta"),
        cache_shapes(tcfg, 1, 8))
    got = {name: quant_chain_block_nbytes(ttemplate, 16, pq.get_spec(name))
           for name in ("none", "int8", "fp8")}
    want = {name: jax_quant_nbytes(jtemplate, 16, rq.get_spec(name))
            for name in ("none", "int8", "fp8")}
    assert got == want
    if not smoke:
        assert got == {"none": 917_504, "int8": 458_976, "fp8": 458_976}
        assert got["none"] / got["int8"] == pytest.approx(1.999, abs=5e-4)
