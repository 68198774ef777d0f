"""The port's main path as a whole, on the CPU: scene -> morton -> radix
sort, against the JAX package (morton.encode + the hybrid radix sort at
block 1024) and the C++ pipeline oracle; the CLI; and the rules that the
port never imports JAX and never falls back from a requested CUDA device.
Tolerance: exact equality of keys and payload order."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_qe import morton as jmorton  # noqa: E402
from tpu_qe.__main__ import main as jax_main  # noqa: E402
from tpu_qe.sort import sort_u64 as jax_sort_u64  # noqa: E402
from tpu_qe_torch import morton, native, pipeline  # noqa: E402
from tpu_qe_torch.__main__ import main  # noqa: E402
from tpu_qe_torch.config import (EngineConfig, SceneConfig,  # noqa: E402
                                 SortConfig, resolve_device)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **kw):
    return subprocess.run([sys.executable] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=300, **kw)


@pytest.mark.parametrize("bpp,passes", [(8, 8), (6, 11)])
def test_sorted_morton_index_matches_jax_and_oracle(bpp, passes):
    verts, tris, smin, smax = native.scene_generate(1000, 3000, 7)
    jp = jmorton.MortonParams.for_scene(smin, smax)
    code = jmorton.encode(jnp.asarray(verts),
                          jnp.asarray(tris.astype(np.int32)), jp)
    jk, (jidx,) = jax_sort_u64(code, jnp.arange(3000, dtype=jnp.uint32),
                               backend="hybrid", block=1024)
    tp = morton.MortonParams.from_reference(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    got = pipeline.sorted_morton_index(
        torch.from_numpy(verts), torch.from_numpy(tris.astype(np.int32)), tp,
        SortConfig(bits_per_pass=bpp, num_passes=passes, block=1024))
    keys, order = got.code.to_numpy(), got.order.numpy().view(np.uint32)
    np.testing.assert_array_equal(keys, jk.to_numpy())
    np.testing.assert_array_equal(order, np.asarray(jidx))
    ocodes, oidx = native.pipeline_oracle(1000, 3000, 7)
    np.testing.assert_array_equal(keys, ocodes)
    np.testing.assert_array_equal(order, oidx)


def test_build_scene_index_on_cpu_matches_oracle():
    idx = pipeline.build_scene_index(SceneConfig(500, 2000, 3),
                                     SortConfig(backend="radix"), "cpu")
    ocodes, oidx = native.pipeline_oracle(500, 2000, 3)
    np.testing.assert_array_equal(idx.code.to_numpy(), ocodes)
    np.testing.assert_array_equal(idx.order.numpy().view(np.uint32), oidx)


def test_verify_cli_passes_on_cpu():
    r = _run(["-m", "tpu_qe_torch", "verify", "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "VERIFY PASS"


@pytest.mark.parametrize("extra", [["--backend", "torch"],
                                   ["--bits-per-pass", "6", "--num-passes",
                                    "11", "--triangles", "4000"]])
def test_verify_in_process_variants(extra, capsys):
    assert main(["verify", "--device", "cpu"] + extra) == 0
    assert capsys.readouterr().out.strip().endswith("VERIFY PASS")


def test_verify_writes_a_trace_with_the_stage_markers(tmp_path, capsys):
    assert main(["verify", "--device", "cpu", "--triangles", "1500",
                 "--trace-dir", str(tmp_path)]) == 0
    trace = (tmp_path / "trace.json").read_text()
    for name in ("compute morton code", "radix sort",
                 "radix sort histogram pass 0", "radix sort scan pass 7",
                 "radix sort scatter pass 7"):
        assert f'"{name}"' in trace, name


def test_package_never_imports_jax():
    code = ("import sys\n"
            "import tpu_qe_torch, tpu_qe_torch.__main__, tpu_qe_torch.bits\n"
            "import tpu_qe_torch.config, tpu_qe_torch.constants\n"
            "import tpu_qe_torch.native, tpu_qe_torch.morton\n"
            "import tpu_qe_torch.pipeline, tpu_qe_torch.sort\n"
            "import tpu_qe_torch.sort.driver, tpu_qe_torch.kernels\n"
            "import tpu_qe_torch.kernels.histogram\n"
            "import tpu_qe_torch.kernels.scan, tpu_qe_torch.bench.sol\n"
            "import tpu_qe_torch.bench.headline\n"
            "import tpu_qe_torch.utils.timing, tpu_qe_torch.utils.profiling\n"
            "import tpu_qe_torch.utils.dump, tpu_qe_torch.utils.build\n"
            "from tpu_qe_torch.__main__ import main\n"
            "assert main(['verify', '--device', 'cpu', '--triangles', '500'])"
            " == 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_qe'))\n"
            "assert not bad, bad\n"
            "print('no jax')\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("no jax")


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["verify", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.build_scene_index(device="cuda")
    r = _run(["-m", "tpu_qe_torch", "verify"])
    assert r.returncode != 0 and "VERIFY" not in r.stdout


def test_bench_refuses_the_cpu():
    with pytest.raises(RuntimeError):
        main(["bench", "--n", "1024", "--device", "cpu"])


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("quirk", [False, True])
def test_dump_byte_matches_jax_dump(tmp_path, quirk):
    flags = ["--vertices", "1000", "--triangles", "256", "--seed", "7"] + (
        ["--quirk-lut"] if quirk else [])
    paths = {}
    for name, fn in (("jax", jax_main), ("torch", main)):
        c, i = tmp_path / f"{name}_codes.txt", tmp_path / f"{name}_idx.txt"
        assert fn(["dump", *flags, "--codes-path", str(c),
                   "--indices-path", str(i)]) == 0
        paths[name] = (c.read_bytes(), i.read_bytes())
    assert paths["jax"] == paths["torch"]
    assert paths["torch"][0].count(b"\n") == 256


def test_info_on_cpu(capsys):
    assert main(["info", "--device", "cpu"]) == 0
    assert "config: EngineConfig" in capsys.readouterr().out


@pytest.mark.parametrize("kw", [{"bits_per_pass": 0}, {"bits_per_pass": 17},
                                {"bits_per_pass": 8, "num_passes": 9},
                                {"block": 0}, {"backend": "xla"}])
def test_sort_config_validation(kw):
    with pytest.raises(ValueError):
        SortConfig(**kw)


def test_engine_config_env_overrides(monkeypatch):
    monkeypatch.setenv("TPU_QE_TORCH_BITS_PER_PASS", "6")
    monkeypatch.setenv("TPU_QE_TORCH_NUM_PASSES", "11")
    monkeypatch.setenv("TPU_QE_TORCH_BACKEND", "torch")
    monkeypatch.setenv("TPU_QE_TORCH_NUM_TRIANGLES", "123")
    cfg = EngineConfig.from_env()
    assert (cfg.sort.bits_per_pass, cfg.sort.num_passes) == (6, 11)
    assert cfg.sort.key_bits == 64 and cfg.sort.backend == "torch"
    assert cfg.scene.num_triangles == 123
    assert EngineConfig().sort.backend == "radix"
