"""The port's main path as a whole, on the CPU: scene -> morton -> radix
sort, against the JAX package (morton.encode + the hybrid radix sort at
block 1024) and the C++ pipeline oracle; the CLI; and the rules that the
port never imports JAX and never falls back from a requested CUDA device.
Tolerance: exact equality of keys and payload order."""

import ast
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
from tpu_qe_torch.sort import sort_u64_numpy  # noqa: E402
from tpu_qe_torch.table import Table  # noqa: E402

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
                                   ["--backend", "torch_tiebreak"],
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
    # every module of the package, then verify, with an audit hook that
    # records each file opened under tpu_qe/
    code = ("import os, pkgutil, sys, importlib\n"
            "jax_pkg = os.path.join(os.getcwd(), 'tpu_qe') + os.sep\n"
            "opened = []\n"
            "def hook(event, args):\n"
            "    if event == 'open' and isinstance(args[0], str) and \\\n"
            "            os.path.abspath(args[0]).startswith(jax_pkg):\n"
            "        opened.append(args[0])\n"
            "sys.addaudithook(hook)\n"
            "import tpu_qe_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    tpu_qe_torch.__path__, 'tpu_qe_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "from tpu_qe_torch.__main__ import main\n"
            "assert main(['verify', '--device', 'cpu', '--triangles', '500'])"
            " == 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_qe'))\n"
            "assert not bad, bad\n"
            "assert not opened, opened\n"
            "print(' '.join(names))\n"
            "print(len(names), 'modules, no jax')\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    *_, walked, last = r.stdout.strip().splitlines()
    count, rest = last.split(" ", 1)
    assert rest == "modules, no jax"
    # ops.*, sort.planes, table, hashing, bench.* among them
    assert int(count) >= 30
    assert {f"tpu_qe_torch.ops.big{m}" for m in ("quantile", "window",
                                                  "orderby")} | {
        "tpu_qe_torch.sql", "tpu_qe_torch.sql.parser"} <= set(walked.split())


def test_core_is_a_byte_identical_copy_of_the_jax_packages():
    def read(*parts):
        with open(os.path.join(REPO, *parts), "rb") as f:
            return f.read()
    assert read("tpu_qe_torch", "cpp", "core.cc") == read("tpu_qe", "cpp",
                                                          "core.cc")
    assert native._SRC == os.path.join(REPO, "tpu_qe_torch", "cpp",
                                       "core.cc")


def _paths_into_the_jax_package(path):
    """String constants of a source file that name tpu_qe/ as a path: the
    bare component "tpu_qe", or "tpu_qe/..." given to a call."""
    with open(path) as f:
        tree = ast.parse(f.read())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and node.value == "tpu_qe":
            found.append(node.lineno)
        if isinstance(node, ast.Call):
            for a in [*node.args, *(k.value for k in node.keywords)]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                        and a.value.startswith(("tpu_qe/", "tpu_qe\\")):
                    found.append(a.lineno)
    return sorted(found)


def test_no_file_of_the_port_builds_a_path_into_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f)
        for d, _, fs in os.walk(os.path.join(REPO, "tpu_qe_torch"))
        for f in fs if f.endswith(".py")]
    assert len(files) > 30
    bad = {f: lines for f in files
           if (lines := _paths_into_the_jax_package(f))}
    assert not bad, bad


def test_path_check_finds_the_old_binding(tmp_path):
    src = tmp_path / "old.py"
    src.write_text('import os\n_SRC = os.path.join(os.path.dirname(__file__),'
                   ' "tpu_qe", "cpp", "core.cc")\n'
                   'open("tpu_qe/cpp/core.cc")\n')
    assert _paths_into_the_jax_package(str(src)) == [2, 3]


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cols = {"k": np.arange(5, dtype=np.uint64),
            "v": np.arange(5, dtype=np.int32)}
    path = Table.from_numpy(cols, device="cpu").save(str(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Table.from_numpy(cols)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Table.load(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sort_u64_numpy(cols["k"])
    assert Table.load(path, device="cpu")["v"].device.type == "cpu"
    np.testing.assert_array_equal(sort_u64_numpy(cols["k"][::-1],
                                                 device="cpu"), cols["k"])


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


@pytest.mark.parametrize("args", [["-m", "tpu_qe_torch", "bench-kernels",
                                   "--n", "8192"],
                                  ["-m", "tpu_qe_torch.selfcheck"]])
def test_card_paths_fail_without_cuda(args):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    r = _run(args)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert "PASS" not in r.stdout and '"kernel ' not in r.stdout


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
