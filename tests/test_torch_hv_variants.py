"""The Hv variants B9 (lane-packed stream) and B10 (G blocks per CTA) and
the port of their comparison, ``one_class_ffm_torch.hv_pack_bench``.

The TPU kernels live in ``scripts/hv_pack_bench.py``, which is not a
package: it is loaded by file path.  Its Pallas kernels run in interpret
mode at the script's own CPU shapes (8 blocks, MAXC 64, k = 32, 256 rows per
block); the bound is max-rel 1e-6 at float32 (the TPU kernels sum a row's
slots in another order and round the packed products to storage)."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_class_ffm_tpu.ops import sparse_ops as jops
from one_class_ffm_torch import hv_pack_bench
from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops import sparse_ops as tops

torch.set_num_threads(1)

_SCRIPT = (pathlib.Path(__file__).resolve().parent.parent / "scripts"
           / "hv_pack_bench.py")


@pytest.fixture(scope="module")
def tpu_bench():
    spec = importlib.util.spec_from_file_location("tpu_hv_pack_bench",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stream():
    """The bench's CPU stream at float32, as numpy and torch arrays."""
    s = hv_pack_bench.make_stream(**hv_pack_bench.CPU_SHAPE)
    s = {key: (val.astype(np.float32) if val.dtype == np.float64 else val)
         for key, val in s.items()}
    s["num"] = hv_pack_bench.CPU_SHAPE["n_blocks"] * hv_pack_bench.BM
    return s


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _max_rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


def test_pack_stream_matches_the_original(tpu_bench, stream):
    """The packed rows, owners and weights, exactly (entry e = j * MAXC/4 +
    c at [c, 32j:32j+32], scalars on all 32 lanes of the group)."""
    s = stream
    got = tops.pack_stream(T(s["B"]), T(s["take"]), T(s["own"]), T(s["w"]))
    ref = tpu_bench.pack_stream(jnp.asarray(s["B"]), jnp.asarray(s["take"]),
                                jnp.asarray(s["own"]), jnp.asarray(s["w"]))
    for g, r, dt in zip(got, ref, (torch.float32, torch.int32,
                                   torch.float32)):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    rows, own, w = tops.unpack_rows(*got)
    assert torch.equal(rows, tops.gather_blocked_rows(T(s["B"]),
                                                      T(s["take"])))
    assert torch.equal(own, T(s["own"])) and torch.equal(w, T(s["w"]))


def test_packed_plain_matches_pos_hv_packed_pallas(tpu_bench, stream):
    s, BM = stream, hv_pack_bench.BM
    rows_p, own_p, w_p = tpu_bench.pack_stream(
        jnp.asarray(s["B"]), jnp.asarray(s["take"]), jnp.asarray(s["own"]),
        jnp.asarray(s["w"]))
    ref = tpu_bench.pos_hv_packed_pallas(
        jnp.asarray(s["phi"]), rows_p, own_p, w_p, jnp.asarray(s["dmat"]),
        s["num"], BM, w_scale=0.9, interpret=True)
    kernels.reset_launch_counts()
    got = tops.pos_hv_packed(T(s["phi"]), T(np.array(rows_p)),
                             T(np.array(own_p)), T(np.array(w_p)),
                             T(s["dmat"]), s["num"], BM, 0.9)
    assert sum(kernels.launch_counts().values()) == 0  # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (s["num"], 32)
    assert _max_rel(got.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_g_plain_matches_pos_hv_kt_g_pallas(tpu_bench, stream, groups):
    s, BM = stream, hv_pack_bench.BM
    B, take = jnp.asarray(s["B"]), jnp.asarray(s["take"])
    ref = tpu_bench.pos_hv_kt_g_pallas(
        jnp.asarray(s["phi"]), jops.gather_blocked_rows_t(B, take),
        jnp.asarray(s["own"]), jnp.asarray(s["w"]), jnp.asarray(s["dmat"]),
        s["num"], BM, groups, w_scale=0.9, interpret=True)
    rows = tops.gather_blocked_rows(T(s["B"]), T(s["take"]))
    got = tops.pos_hv_blocked_g(T(s["phi"]), rows, T(s["own"]), T(s["w"]),
                                T(s["dmat"]), s["num"], BM, groups, 0.9)
    assert _max_rel(got.numpy(), ref) <= 1e-6
    # B10 is B1 with another CTA mapping: the same bits as B1
    assert torch.equal(got, tops.pos_hv_blocked(
        T(s["phi"]), rows, T(s["own"]), T(s["w"]), T(s["dmat"]), s["num"],
        BM, 0.9))


def test_variants_reject_what_the_tpu_kernels_reject(stream):
    s = stream
    rows = tops.gather_blocked_rows(T(s["B"]), T(s["take"]))
    with pytest.raises(ValueError, match="divide"):
        tops.pos_hv_blocked_g(T(s["phi"]), rows, T(s["own"]), T(s["w"]),
                              T(s["dmat"]), s["num"], hv_pack_bench.BM, 3)
    with pytest.raises(ValueError, match="k = 32"):
        tops.pack_rows(rows[..., :16], T(s["own"]), T(s["w"]))
    with pytest.raises(ValueError, match="MAXC % 4"):
        tops.pack_rows(rows[:, :62], T(s["own"])[:, :62], T(s["w"])[:, :62])


@pytest.mark.parametrize("op", ["packed", "g"])
def test_variant_wrappers_reject_cpu_tensors(stream, op):
    s = stream
    rows = tops.gather_blocked_rows(T(s["B"]), T(s["take"]))
    with pytest.raises(ValueError, match="CUDA"):
        if op == "packed":
            kernels.pos_hv_packed(T(s["phi"]), *tops.pack_rows(
                rows, T(s["own"]), T(s["w"])), T(s["dmat"]), s["num"],
                hv_pack_bench.BM)
        else:
            kernels.pos_hv_blocked_g(T(s["phi"]), rows, T(s["own"]),
                                     T(s["w"]), T(s["dmat"]), s["num"],
                                     hv_pack_bench.BM, 2)


def test_bench_draws_the_original_stream(tpu_bench, monkeypatch):
    """The bench's inputs are the original's: the original's CPU pass, run
    with the same seed, gathers from the same table with the same ids and
    runs B1 on the same owners, weights and phi (captured at its calls of
    the JAX package's ops; its Pallas kernels are stubbed out here, the
    tests above run them)."""
    seen = {}
    gather, hv = jops.gather_blocked_rows, jops.pos_hv_blocked

    def spy_gather(B, take):
        seen.update(B=np.asarray(B), take=np.asarray(take))
        return gather(B, take)

    def spy_hv(phi, *args, **kw):
        seen.update(phi=np.asarray(phi), own=np.asarray(args[4]),
                    w=np.asarray(kw["w_blk"]))
        return hv(phi, *args, **kw)

    def zeros(*args, **kw):
        return jnp.zeros((8 * 256, 32))

    monkeypatch.setattr(jops, "gather_blocked_rows", spy_gather)
    monkeypatch.setattr(jops, "pos_hv_blocked", spy_hv)
    monkeypatch.setattr(jops, "pos_hv_kt_pallas", zeros)
    monkeypatch.setattr(tpu_bench, "pos_hv_packed_pallas", zeros)
    monkeypatch.setattr(tpu_bench, "pos_hv_kt_g_pallas", zeros)
    assert tpu_bench.main() == 0
    ours = hv_pack_bench.make_stream(**hv_pack_bench.CPU_SHAPE)
    for key in ("take", "own", "w"):
        np.testing.assert_array_equal(seen[key], ours[key])
    for key in ("B", "phi"):
        np.testing.assert_array_equal(seen[key], ours[key].astype(np.float32))


def test_bench_cpu_pass(capsys):
    assert hv_pack_bench.main(["--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "CPU correctness pass done" in out
    for name in ("b1", "packed", "g2", "g4", "g8"):
        assert f"{name}_bit_equal True" in out


def test_bench_refuses_a_missing_gpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        hv_pack_bench.main([])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
