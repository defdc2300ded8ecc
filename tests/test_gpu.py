"""Card-only checks: the CLI's device paths on a GPU against the plain
references, at small sizes.  Run them on a GPU host with
``JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist tests/``; on
the CPU they skip."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gpu_build_graph_matches_numpy(gpu, cs, tmp_path):
    from gossamer_tpu.cli import goss
    from gossamer_tpu.graph.graph import Graph
    from gossamer_tpu.io.factory import PhysicalFileFactory

    rng = np.random.default_rng(11)
    codes = cs.sample_reads(rng, cs.make_genome(rng, 50_000), 20_000, 100,
                            0.002)
    cs.write_fastq(str(tmp_path / "r.fastq"), codes, "r")
    assert goss.main(["build-graph", "-k", "27", "-i",
                      str(tmp_path / "r.fastq"), "-O",
                      str(tmp_path / "g")]) == 0
    g = Graph.read(str(tmp_path / "g"), PhysicalFileFactory())
    keys, counts = cs.spectrum_reference(codes, 28)
    assert np.array_equal(np.asarray(g.lo), keys)
    assert np.array_equal(np.asarray(g.counts).astype(np.int64), counts)


def test_gpu_classify_matches_host_reference(gpu, cs, tmp_path):
    from gossamer_tpu.cli import xenome

    rng = np.random.default_rng(12)
    d = str(tmp_path)
    reads = cs.xeno_inputs(d, rng, scale=0.01)
    assert xenome.main(["index", "-K", "25", "-G", f"{d}/graft.fa",
                        "-H", f"{d}/host.fa", "-P", f"{d}/idx"]) == 0
    assert xenome.main(["classify", "-P", f"{d}/idx", "-i",
                        f"{d}/xreads.fastq", "--output-filename-prefix",
                        f"{d}/cls"]) == 0
    _, want = cs.reference_classes(f"{d}/idx", reads)
    assert (cs.read_classes(f"{d}/cls", len(reads)) == want).all()
