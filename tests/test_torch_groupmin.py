"""The port's group-min pass (tpu_knn_torch/ops/groupmin.py) against the
JAX Pallas kernel in interpret mode, on the same numpy inputs, at every
precision tier. On the CPU the wrapper runs its plain PyTorch version;
the CUDA kernels themselves are held against that version on the card by
chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_knn.ops.pallas_scan import fused_groupmin as jax_groupmin  # noqa: E402
from tpu_knn_torch.ops import groupmin as GM  # noqa: E402
from tpu_knn_torch.tools import groupmin_ablation as ABL  # noqa: E402


def _inputs(qn, n, d=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((qn, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    qt = (q * q).sum(1).astype(np.float32)
    xt = (x * x).sum(1).astype(np.float32)
    return q, x, qt, xt


def _port(q, x, qt, xt, scale=-2.0, **kw):
    t = [torch.from_numpy(a) for a in (q, x, qt, xt)]
    return GM.fused_groupmin(*t, scale, **kw).numpy()


def _jax(q, x, qt, xt, scale=-2.0, tq=16, tc=256):
    """The Pallas kernel in interpret mode (int8 inputs take its int8 tier)."""
    return np.asarray(jax_groupmin(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(qt), jnp.asarray(xt),
        scale=scale, tq=tq, tc=tc, interpret=True,
    ))


def test_groupmin_matches_pallas_interpret():
    # the shapes of tests/test_pallas_kernels.py; atol 1e-3 is the f32
    # summation-order floor of a depth-128 dot of unit normals
    q, x, qt, xt = _inputs(16, 512)
    np.testing.assert_allclose(_port(q, x, qt, xt), _jax(q, x, qt, xt), rtol=1e-5, atol=1e-3)


def test_groupmin_ragged_queries_and_padding_rows():
    """Q=13 needs no padding in the port (the JAX caller pads to 16);
    padding rows carry x_term = 1e30 and stay finite."""
    q, x, qt, xt = _inputs(13, 512, seed=1)
    xt[-200:] = 1e30
    qp = np.concatenate([q, np.zeros((3, 128), np.float32)])
    qtp = np.concatenate([qt, np.zeros(3, np.float32)])
    want = _jax(qp, x, qtp, xt)[:13]
    got = _port(q, x, qt, xt)
    assert got.shape == (13, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("chunk_bytes", [16 * 128 * 4, 1 << 28])
def test_groupmin_reference_chunking(chunk_bytes):
    """The plain version's corpus chunking does not change its result."""
    q, x, qt, xt = _inputs(16, 1024, d=16, seed=2)
    t = [torch.from_numpy(a).double() for a in (q, x, qt, xt)]
    got = GM.fused_groupmin_reference(*t, -2.0, chunk_bytes=chunk_bytes).numpy()
    dd = qt[:, None].astype(np.float64) + xt[None, :] - 2.0 * (q.astype(np.float64) @ x.T)
    np.testing.assert_allclose(got, dd.reshape(16, 8, 128).min(2), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize(
    "qn,n,d,precision",
    [(16, 500, 128, "float32"), (16, 512, 12, "float32"), (16, 512, 128, "fp8")],
)
def test_groupmin_contract_raises(qn, n, d, precision):
    """n % 128 != 0 and d % 8 != 0 raise, as on the TPU; so does a pass-1
    tier that does not exist."""
    q, x, qt, xt = _inputs(qn, n, d=d)
    with pytest.raises(ValueError):
        _port(q, x, qt, xt, precision=precision)


def _int8_inputs(qn, n, seed):
    rng = np.random.default_rng(seed)
    q8 = rng.integers(-128, 128, size=(qn, 128)).astype(np.int8)
    x8 = rng.integers(-128, 128, size=(n, 128)).astype(np.int8)
    qt = rng.integers(0, 1 << 20, size=qn).astype(np.float32)
    xt = rng.integers(0, 1 << 20, size=n).astype(np.float32)
    return q8, x8, qt, xt


@pytest.mark.parametrize("precision", ["float32", "high"])
def test_groupmin_int8_tier_matches_pallas_interpret(precision):
    """int8 inputs run the exact int8 tier whatever the precision says, as
    the TPU kernel does: bit-equal (atol 0) to Pallas in interpret mode and
    to the exact int64 product, at the shapes of tests/test_pallas_kernels.py."""
    q8, x8, qt, xt = _int8_inputs(16, 256, seed=3)
    got = _port(q8, x8, qt, xt, precision=precision)
    np.testing.assert_array_equal(got, _jax(q8, x8, qt, xt, tc=256))
    g = q8.astype(np.int64) @ x8.astype(np.int64).T
    want = (qt[:, None] + xt[None, :] - 2 * g).reshape(16, 2, 128).min(2)
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("precision", ["high", "bfloat16"])
def test_groupmin_reduced_tiers_match_pallas_interpret(precision):
    """The plain bf16x3 and bf16 versions (bf16-rounded values, f32
    matmuls) against the Pallas kernel in interpret mode; atol 1e-3 is the
    f32 summation-order floor of a depth-128 dot of unit normals."""
    q, x, qt, xt = _inputs(16, 512, seed=4)
    got = _port(q, x, qt, xt, precision=precision)
    want = np.asarray(jax_groupmin(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(qt), jnp.asarray(xt),
        scale=-2.0, tq=16, tc=256, interpret=True, precision=precision,
    ))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # and it is a reduced tier, not the f32 one
    assert not np.array_equal(got, _port(q, x, qt, xt))


def test_groupmin_reduced_tier_split_is_exact_in_f64():
    """The f64 plain version sees the same bf16 values as the f32 one, so
    the two differ only by f32 summation (the card's kernel check relies on it)."""
    q, x, qt, xt = _inputs(16, 256, seed=5)
    t = [torch.from_numpy(a) for a in (q, x, qt, xt)]
    for tier in ("high", "bfloat16"):
        f32 = GM.fused_groupmin_reference(*t, -2.0, precision=tier).double()
        f64 = GM.fused_groupmin_reference(*(a.double() for a in t), -2.0, precision=tier)
        np.testing.assert_allclose(f32.numpy(), f64.numpy(), rtol=1e-5, atol=1e-3)


def test_groupmin_wrong_dtype_raises():
    """A tier runs on its own dtype only: int8 q with f32 x, or f64 q, raise."""
    q8, x8, qt, xt = _int8_inputs(16, 256, seed=6)
    with pytest.raises(ValueError, match="int8"):
        GM.fused_groupmin(torch.from_numpy(q8), torch.from_numpy(x8).float(),
                          torch.from_numpy(qt), torch.from_numpy(xt), -2.0)
    q, x, qt, xt = _inputs(16, 256)
    with pytest.raises(ValueError, match="float32"):
        GM.fused_groupmin(torch.from_numpy(q).double(), torch.from_numpy(x).double(),
                          torch.from_numpy(qt), torch.from_numpy(xt), -2.0, precision="high")


def test_groupmin_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc the build fails loudly and creates nothing."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(GM, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        GM.build()
    assert not (tmp_path / "build").exists()
    assert GM.launches == dict.fromkeys(GM.TIERS, 0)


# ---- the wiring of the three kernel libraries, with the library faked ----


class _FakeFn:
    def __init__(self):
        self.argtypes = None
        self.restype = None


class _FakeLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _FakeFn())


def test_groupmin_sources_and_entries():
    """f32 -> groupmin.cu, int8 -> groupmin_wgmma_i8.cu, high and bfloat16 ->
    groupmin_wgmma.cu; the two wgmma libraries take the query-image scratch,
    each sized by its own function."""
    assert {n: p.name for n, p in GM.SOURCES.items()} == {
        "groupmin": "groupmin.cu", "groupmin_wgmma": "groupmin_wgmma.cu",
        "groupmin_wgmma_i8": "groupmin_wgmma_i8.cu"}
    assert all(p.exists() for p in GM.SOURCES.values())
    assert not (GM.INCLUDE_DIR / "groupmin_mma.cu").exists()
    assert GM._ENTRY == {
        "float32": ("groupmin", "tk_groupmin_f32", 8),
        "int8": ("groupmin_wgmma_i8", "tk_groupmin_i8", 16),
        "high": ("groupmin_wgmma", "tk_groupmin_bf16x3", 8),
        "bfloat16": ("groupmin_wgmma", "tk_groupmin_bf16", 8),
    }
    assert {n: f for n, (f, _) in GM._SCRATCH_BYTES.items()} == {
        "groupmin_wgmma": "tk_groupmin_wgmma_scratch_bytes", "groupmin_wgmma_i8": "tk_groupmin_i8_scratch_bytes"}


@pytest.mark.parametrize("name", ["groupmin", "groupmin_wgmma_i8", "groupmin_wgmma"])
def test_groupmin_load_sets_argtypes(monkeypatch, tmp_path, name):
    """Every pointer is a c_void_p (ctypes would cut it to 32 bits as an
    int), counts are 64-bit; the entries of the two wgmma libraries also
    take (scratch, bytes), sized by (nq, d) for int8 and (nq, d, bf16x3)
    for the bf16 tiers."""
    import ctypes

    fake = _FakeLib()
    monkeypatch.setattr(GM, "_libs", {})
    monkeypatch.setattr(GM, "build", lambda n: tmp_path / f"{n}.so")
    monkeypatch.setattr(GM.ctypes, "CDLL", lambda path: fake)
    assert GM._load(name) is fake and GM._libs == {name: fake}
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    base = [p, p, p, p, p, i64, i64, ctypes.c_int, ctypes.c_float]
    want = base + ([p, i64] if name != "groupmin" else []) + [p]
    entries = [e for lib, e, _ in GM._ENTRY.values() if lib == name]
    assert entries and all(fake.fns[e].argtypes == want and fake.fns[e].restype is ctypes.c_int
                           for e in entries)
    if name == "groupmin_wgmma":
        sb = fake.fns["tk_groupmin_wgmma_scratch_bytes"]
        assert sb.argtypes == [i64, ctypes.c_int, ctypes.c_int] and sb.restype is i64
    elif name == "groupmin_wgmma_i8":
        sb = fake.fns["tk_groupmin_i8_scratch_bytes"]
        assert sb.argtypes == [i64, ctypes.c_int] and sb.restype is i64
    else:
        assert not any("scratch" in f for f in fake.fns)
    assert fake.fns["tk_error_string"].restype is ctypes.c_char_p


@pytest.mark.parametrize("tier", ["high", "bfloat16"])
@pytest.mark.parametrize("n,d", [(500, 128), (512, 12), (640, 20)])
def test_groupmin_reduced_tier_contract_raises(tier, n, d):
    """The wgmma tiers keep the contract: n % 128 == 0 and d % 8 == 0."""
    q, x, qt, xt = _inputs(16, n, d=d)
    with pytest.raises(ValueError, match="n%128==0 and d%8==0"):
        _port(q, x, qt, xt, precision=tier)


@pytest.mark.parametrize("name", ["groupmin", "groupmin_wgmma_i8", "groupmin_wgmma"])
def test_groupmin_build_all_without_nvcc_raises(monkeypatch, tmp_path, name):
    """Each library's build fails loudly without nvcc and creates nothing."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(GM, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        GM.build_all((name,))
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("precision", ["high", "bfloat16"])
@pytest.mark.parametrize("qn,n,d", [(7, 384, 24), (13, 256, 136), (1, 128, 128), (5, 128, 960)])
def test_groupmin_reduced_tiers_edge_shapes_match_pallas_interpret(precision, qn, n, d):
    """The CPU path of the wgmma tiers at the kernel's edge shapes (a
    ragged query tile, an odd group count, a partial k-step, gist's D=960,
    which the kernel runs in K chunks) against the Pallas kernel in
    interpret mode, queries padded to its 16-row tile; atol 1e-3 as above."""
    q, x, qt, xt = _inputs(qn, n, d=d, seed=qn + d)
    pad = -qn % 16
    qp = np.concatenate([q, np.zeros((pad, d), np.float32)])
    qtp = np.concatenate([qt, np.zeros(pad, np.float32)])
    want = np.asarray(jax_groupmin(
        jnp.asarray(qp), jnp.asarray(x), jnp.asarray(qtp), jnp.asarray(xt),
        scale=-2.0, tq=16, tc=128, interpret=True, precision=precision,
    ))[:qn]
    got = _port(q, x, qt, xt, precision=precision)
    assert got.shape == (qn, n // 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("variant", list(ABL.VARIANTS))
def test_groupmin_ablation_variants_apply_to_the_kernel(variant):
    """Every ablation variant's parts are found once in the shipped wgmma
    source, so the tool still switches off what it says it does."""
    src = GM.SOURCES["groupmin_wgmma"].read_text()
    out = ABL.variant_source(src, ABL.VARIANTS[variant])
    assert (out == src) == (variant == "full")
    with pytest.raises(RuntimeError, match="not in the kernel source once"):
        ABL.variant_source(out + out, ABL.VARIANTS["half_mma"])


@pytest.mark.parametrize("variant", list(ABL.VARIANTS_I8))
def test_groupmin_ablation_int8_variants_apply_to_the_kernel(variant):
    """The same for the int8 source: every int8 patch is found once in
    groupmin_wgmma_i8.cu, the five variants that switch a part off exist, and
    only variants that keep the function are held bit-equal to plain."""
    src = GM.SOURCES["groupmin_wgmma_i8"].read_text()
    out = ABL.variant_source(src, ABL.VARIANTS_I8[variant], ABL.PATCHES_I8)
    assert (out == src) == (variant == "full")
    assert {"half_mma", "epi4", "no_store", "no_split", "mma_only"} <= set(ABL.VARIANTS_I8)
    assert set(ABL.EXACT_I8) <= set(ABL.VARIANTS_I8) and "mma_only" not in ABL.EXACT_I8
    for part in ABL.VARIANTS_I8[variant]:
        assert src.count(ABL.PATCHES_I8[part][0]) == 1
    with pytest.raises(RuntimeError, match="not in the kernel source once"):
        ABL.variant_source(out + out, ABL.VARIANTS_I8["half_mma"], ABL.PATCHES_I8)


def test_groupmin_ablation_reads_spills_from_ptxas_output():
    log = (
        "ptxas info    : Compiling entry function '_ZN3abc18groupmin_i8_kernelILi2ELb1ELb0ELb1EEEvNS_4ArgsE' for 'sm_90a'\n"
        "    16 bytes stack frame, 120 bytes spill stores, 112 bytes spill loads\n"
        "ptxas info    : Compiling entry function '_ZN3abc18groupmin_i8_kernelILi1ELb0ELb0ELb1EEEvNS_4ArgsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    )
    assert ABL.spills(log) == {"2,1,0,1": "16 bytes stack frame, 120 bytes spill stores, 112 bytes spill loads"}
    assert ABL.spills("") == {}


def test_groupmin_kernel_sources_split_by_instruction():
    """int8 runs on wgmma s8 in groupmin_wgmma_i8.cu, bf16x3 and bf16 on
    wgmma bf16 in groupmin_wgmma.cu; no source keeps a warp-level mma.sync."""
    i8 = GM.SOURCES["groupmin_wgmma_i8"].read_text()
    wg = GM.SOURCES["groupmin_wgmma"].read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in i8 and "mma.sync" not in i8
    assert "tk_groupmin_i8(" in i8 and "tk_groupmin_i8_scratch_bytes" in i8
    assert "bf16.bf16" not in i8 and "__nv_bfloat16" not in i8 and "tk_groupmin_bf16" not in i8
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in wg and "mma.sync.aligned" not in wg
    assert "tk_groupmin_bf16x3" in wg and "tk_groupmin_bf16(" in wg and "tk_groupmin_i8" not in wg
    for src in (i8, wg):  # both take the shared helpers from the header, and define none of them
        assert '#include "wgmma_common.cuh"' in src and "mbarrier.init" not in src
    assert "mbarrier.init" in (GM.INCLUDE_DIR / "wgmma_common.cuh").read_text()


def test_groupmin_library_key_follows_included_headers(monkeypatch, tmp_path):
    """A library is keyed by its source and by every file the source
    includes, directly or through another header: editing a shared header
    changes the key of each library that includes it and of no other."""
    inc = tmp_path / "inc"
    inc.mkdir()
    (inc / "common.cuh").write_text('#pragma once\n#include "deep.cuh"\nint one();\n')
    (inc / "deep.cuh").write_text("#pragma once\nint two();\n")
    (tmp_path / "a.cu").write_text('#include <stdint.h>\n  #  include "common.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <stdint.h>\nint b;\n")
    monkeypatch.setattr(GM, "INCLUDE_DIR", inc)
    monkeypatch.setattr(GM, "SOURCES", {"a": tmp_path / "a.cu", "b": tmp_path / "b.cu"})
    before = {n: GM._lib_path(n) for n in ("a", "b")}
    assert GM._lib_path("a") == before["a"]
    (inc / "deep.cuh").write_text("#pragma once\nint two();  // edited\n")
    assert GM._lib_path("a") != before["a"] and GM._lib_path("b") == before["b"]
    mid = GM._lib_path("a")
    (inc / "common.cuh").write_text('#pragma once\n#include "deep.cuh"\nint one();  // edited\n')
    assert GM._lib_path("a") != mid
    (tmp_path / "a.cu").write_text('#include "missing.cuh"\n')
    with pytest.raises(RuntimeError, match="missing.cuh"):
        GM._lib_path("a")


def test_groupmin_shipped_libraries_are_keyed_by_the_shared_header(monkeypatch, tmp_path):
    """The two wgmma sources include csrc/wgmma_common.cuh, the f32 source
    does not: a changed copy of the header changes exactly their keys."""
    import shutil

    shutil.copytree(GM.INCLUDE_DIR, tmp_path / "csrc")
    monkeypatch.setattr(GM, "INCLUDE_DIR", tmp_path / "csrc")
    monkeypatch.setattr(GM, "SOURCES", {n: tmp_path / "csrc" / p.name for n, p in GM.SOURCES.items()})
    before = {n: GM._lib_path(n).name for n in GM.SOURCES}
    with open(tmp_path / "csrc" / "wgmma_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: GM._lib_path(n).name for n in GM.SOURCES}
    assert {n for n in before if before[n] != after[n]} == {"groupmin_wgmma", "groupmin_wgmma_i8"}


def _int8_edge_inputs(qn, n, d, seed):
    rng = np.random.default_rng(seed)
    q8 = rng.integers(-128, 128, size=(qn, d)).astype(np.int8)
    x8 = rng.integers(-128, 128, size=(n, d)).astype(np.int8)
    qt = (rng.random(qn) * 2e6).astype(np.float32)
    xt = (rng.random(n) * 2e6).astype(np.float32)
    xt[-37:] = 1e30  # padding rows
    return q8, x8, qt, xt


@pytest.mark.parametrize("scale", [-2.0, -0.3])
@pytest.mark.parametrize("qn,n,d", [(7, 384, 16), (13, 640, 48), (1, 128, 128), (5, 384, 144), (3, 128, 960)])
def test_groupmin_int8_edge_shapes_match_pallas_interpret(qn, n, d, scale):
    """The CPU path of the int8 tier at the kernel's edge shapes (a ragged
    query tile, an odd group count, partial k-steps and slabs at D = 16, 48
    and 144, gist's D = 960), with non-integer row terms and 1e30 on the
    trailing rows. At l2sqr_sift's scale -2 (a power of two: the kernel's
    fused multiply-add epilogue) it equals the Pallas kernel in interpret
    mode, queries padded to its 16-row tile, bit for bit (atol 0). At scale
    -0.3 the product is rounded before x_term is added: bit-equal to an
    int64 numpy oracle rounded so, and within one f32 ulp of the terms'
    magnitude (2^-23 (|scale| max|dot| + max q_term + max x_term)) of
    Pallas, whose CPU lowering may fuse the multiply and the add."""
    q8, x8, qt, xt = _int8_edge_inputs(qn, n, d, seed=qn + d)
    pad = -qn % 16
    qp = np.concatenate([q8, np.zeros((pad, d), np.int8)])
    qtp = np.concatenate([qt, np.zeros(pad, np.float32)])
    want = _jax(qp, x8, qtp, xt, scale=scale, tc=128)[:qn]
    got = _port(q8, x8, qt, xt, scale=scale)
    assert got.shape == (qn, n // 128) and got.dtype == np.float32
    dot = (q8.astype(np.int64) @ x8.astype(np.int64).T).astype(np.float32)
    oracle = ((np.float32(scale) * dot + xt[None, :]) + qt[:, None]).reshape(qn, n // 128, 128).min(2)
    np.testing.assert_array_equal(got, oracle)
    if scale == -2.0:
        np.testing.assert_array_equal(got, want)
    else:
        ulp = 2.0 ** -23 * (abs(scale) * float(np.abs(dot).max()) + float(qt.max()) + 2e6)
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


@pytest.mark.parametrize("d", [128, 960])
def test_groupmin_int8_extreme_rows_match_int64_oracle(d):
    """Rows of all -128 and all 127, the largest |dot| an int8 pair has
    (D * 2^14 <= 2^24 up to D = 1024, so its f32 image is exact): queries of
    all -128 and all 127 against groups that hold such rows, equal bit for
    bit to an int64 numpy oracle rounded as the kernel rounds (the scaled
    dot, then x_term, then q_term, each an f32 operation) and to the Pallas
    kernel in interpret mode."""
    q8, x8, qt, xt = _int8_edge_inputs(16, 256, d, seed=d)
    q8[0], q8[1] = -128, 127
    x8[0], x8[1], x8[200], x8[201] = -128, 127, 127, -128
    xt[:2] = 0.0  # so that the extreme pairs decide their group's min
    got = _port(q8, x8, qt, xt)
    dot = q8.astype(np.int64) @ x8.astype(np.int64).T
    assert dot.max() == 128 * 128 * d and dot.min() == -128 * 127 * d
    z = (np.float32(-2.0) * dot.astype(np.float32) + xt[None, :]) + qt[:, None]
    assert z.dtype == np.float32
    want = z.reshape(16, 2, 128).min(2)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == np.float32(-2.0 * 128 * 128 * d) + qt[0]
    np.testing.assert_array_equal(got, _jax(q8, x8, qt, xt, tc=128))
