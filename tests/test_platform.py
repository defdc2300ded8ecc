"""Platform plumbing: the accelerator predicate and ``--num-devices 0``,
the compile-cache rule, the native library's build stamp and
``chip_smoke.py``'s refusal to run without a GPU."""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import gossamer_tpu
from gossamer_tpu.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------- accelerator predicate
def test_cpu_backend_is_not_an_accelerator():
    assert not mesh.accelerator_present()
    assert mesh.auto_num_devices() == 1


def test_auto_num_devices_takes_every_gpu(monkeypatch):
    import jax

    monkeypatch.setattr(mesh, "accelerator_present", lambda: True)
    assert mesh.auto_num_devices() == len(jax.devices()) == 8


class _Ctx:
    def __init__(self, num_devices, chunk_size):
        self.opts = argparse.Namespace(num_devices=num_devices,
                                       chunk_size=chunk_size)


@pytest.mark.parametrize("gpu,n,rho,chunk,want", [
    (False, 0, 28, 1 << 22, 1),   # CPU: auto is one device
    (True, 0, 28, 1 << 22, 8),    # GPU host: every card
    (True, 0, 41, 1 << 22, 1),    # wide keys: the mesh engine is narrow
    (True, 0, 28, 1000, 1),       # packed format needs chunk % 16 == 0
    (False, 2, 28, 1 << 22, 2),   # an explicit count is honored
])
def test_resolve_num_devices(monkeypatch, gpu, n, rho, chunk, want):
    from gossamer_tpu.cmds.basic import _resolve_num_devices

    monkeypatch.setattr(mesh, "accelerator_present", lambda: gpu)
    assert _resolve_num_devices(_Ctx(n, chunk), rho) == want


def test_xenome_classify_auto_devices_on_gpu_host(monkeypatch, tmp_path):
    """``xenome classify`` without --num-devices on a (simulated) GPU
    host shards the index over every device, with output identical to
    one device."""
    from gossamer_tpu.cli.xenome import build_app

    rng = np.random.default_rng(5)
    graft = "".join("ACGT"[b] for b in rng.integers(0, 4, 400))
    host = "".join("ACGT"[b] for b in rng.integers(0, 4, 400))
    (tmp_path / "graft.fa").write_text(f">g\n{graft}\n")
    (tmp_path / "host.fa").write_text(f">h\n{host}\n")
    reads = [graft[p : p + 60] for p in range(0, 300, 23)]
    reads += [host[p : p + 60] for p in range(0, 300, 29)]
    (tmp_path / "r.fq").write_text("".join(
        f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    app = build_app()
    pfx = str(tmp_path / "idx")
    assert app.main(["index", "-K", "15", "-G", str(tmp_path / "graft.fa"),
                     "-H", str(tmp_path / "host.fa"), "-P", pfx]) == 0
    used = []
    from gossamer_tpu.classify import xenome as X

    real = X._slice_blrg
    monkeypatch.setattr(X, "_slice_blrg", lambda c, s, n=1: (
        used.append(n), real(c, s, n))[1])
    for tag, gpu in (("one", False), ("auto", True)):
        monkeypatch.setattr(mesh, "accelerator_present", lambda g=gpu: g)
        assert app.main(["classify", "-P", pfx, "-i", str(tmp_path / "r.fq"),
                         "--output-filename-prefix",
                         str(tmp_path / tag)]) == 0
    assert set(used) == {1, 8}
    for cls in ("graft", "host", "both", "neither", "ambiguous"):
        a, b = tmp_path / f"one_{cls}.fastq", tmp_path / f"auto_{cls}.fastq"
        assert a.read_text() == b.read_text(), cls


# ------------------------------------------------------- compile cache
def test_compile_cache_dir_without_env_is_in_checkout():
    assert gossamer_tpu._compile_cache_dir({}) == os.path.join(
        ROOT, ".jax_cache")


def test_compile_cache_dir_defers_to_env():
    assert gossamer_tpu._compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_dir_after_import(tmp_path, env_dir):
    """In a fresh process: JAX's own variable wins when set, and the
    package sets no other directory; otherwise the checkout's."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", "import gossamer_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = str(tmp_path) if env_dir else os.path.join(ROOT, ".jax_cache")
    assert out.stdout.strip() == want


# --------------------------------------------------- native build stamp
@pytest.fixture
def native_copy(tmp_path):
    from gossamer_tpu.io import native

    d = tmp_path / "native"
    d.mkdir()
    for name in ("gossio.cpp", "Makefile"):
        shutil.copy(os.path.join(native._native_dir(), name), d / name)
    builds = []

    def fake_build(src_dir, out):
        builds.append(out)
        with open(out, "wb") as f:
            f.write(b"library %d" % len(builds))

    return native, str(d), builds, fake_build


def test_native_builds_once_then_reuses(native_copy):
    native, d, builds, build = native_copy
    so = native.ensure_built(d, build)
    assert len(builds) == 1 and os.path.exists(so)
    assert open(so, "rb").read() == b"library 1"
    native.ensure_built(d, build)
    assert len(builds) == 1


def test_native_rebuilds_when_sources_change(native_copy):
    """Same mtimes are no evidence: only the stamp decides."""
    native, d, builds, build = native_copy
    native.ensure_built(d, build)
    mk = os.path.join(d, "Makefile")
    st = os.stat(mk)
    with open(mk, "a") as f:
        f.write("# changed\n")
    os.utime(mk, ns=(st.st_atime_ns, st.st_mtime_ns))
    native.ensure_built(d, build)
    assert len(builds) == 2


def test_native_rebuilds_for_another_cpu(native_copy, monkeypatch):
    """A library built (or copied in) from a host with other CPU flags
    is rebuilt here, since the build uses -march=native."""
    native, d, builds, build = native_copy
    native.ensure_built(d, build)
    monkeypatch.setattr(native, "_cpu_flags", lambda: "another cpu")
    native.ensure_built(d, build)
    assert len(builds) == 2


def test_native_rebuilds_without_stamp(native_copy):
    """A library without a stamp (e.g. copied from elsewhere) is never
    trusted."""
    native, d, builds, build = native_copy
    native.ensure_built(d, build)
    os.remove(os.path.join(d, "libgossio.stamp"))
    native.ensure_built(d, build)
    assert len(builds) == 2
    assert not [n for n in os.listdir(d) if n.startswith(".libgossio")]


# ------------------------------------------------------------ chip_smoke
@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """Without a GPU (and alone, without the package) chip_smoke.py
    exits non-zero, names the missing GPU and prints no result."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_chip_smoke_spectrum_reference_matches_specmodel():
    """The smoke test's numpy build-graph reference == the brute-force
    spectrum model, on reads with substitution errors."""
    from specmodel import spectrum_build_graph

    cs = _load_chip_smoke()
    rng = np.random.default_rng(3)
    genome = cs.make_genome(rng, 300)
    codes = cs.sample_reads(rng, genome, 40, 30, 0.05)
    keys, counts = cs.spectrum_reference(codes, 12, block=7)
    want = spectrum_build_graph(
        ["".join("ACGT"[b] for b in row) for row in codes], 12)
    assert keys.tolist() == sorted(want)
    assert counts.tolist() == [want[k] for k in sorted(want)]


def test_chip_smoke_names_the_batch_step_sorts():
    """The trace reduction's HLO map finds the counting step's two sorts:
    the 3-operand key sort (two key planes + counts) and the 4-operand
    compaction sort (rank key + planes + running sum)."""
    import jax.numpy as jnp

    from gossamer_tpu.io.stream import pack_chunk
    from gossamer_tpu.ops.engine import batch_step_packed, empty_spec

    cs = _load_chip_smoke()
    rho, chunk, cap = 28, 1024, 4096
    codes = np.random.default_rng(0).integers(
        0, 4, (2, chunk + rho - 1), dtype=np.uint8)
    packed = [pack_chunk(c, rho, chunk) for c in codes]
    stack = [jnp.asarray(np.stack([p[i] for p in packed])) for i in (0, 1)]
    hlo = cs.hlo_ops(batch_step_packed.lower(
        *stack, *empty_spec(cap), rho, "value", cap, chunk).compile()
        .as_text())
    sorts = {name: n for name, (op, n, _) in hlo.items() if op == "sort"}
    assert sorted(sorts.values()) == [3, 4]
    for name, n in sorts.items():
        assert cs._category(name + "_1__7", hlo)[0] == f"sort of {n} operands"
    assert cs._category("MemcpyD2H", hlo)[0] == "host<->device copies"
