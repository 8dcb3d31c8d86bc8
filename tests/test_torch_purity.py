"""The PyTorch port stands alone: it imports no JAX, no flax and nothing of
the JAX package ``ifseg_tpu``, and none of the host libraries that
package's data pipeline uses (PIL, cv2, regex), which the tests may use.

Three checks: a fresh interpreter imports ``ifseg_torch`` and every
submodule and reports what ended up in ``sys.modules``; an AST scan of the
package and of ``chip_smoke.py`` finds no import statement naming those
packages; importing the PNG, JPEG or JPEG 2000 codec starts no compiler (its
host C++ source is built at the first decode).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ifseg_tpu", "PIL", "cv2", "regex")

SCRIPT = r"""
import importlib, json, pkgutil, sys
FORBIDDEN = %r
def bad():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
before = bad()
import ifseg_torch
names = [m.name for m in pkgutil.walk_packages(ifseg_torch.__path__, "ifseg_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"before": before, "after": bad(), "modules": names}))
""" % (FORBIDDEN,)


def test_importing_every_module_loads_no_jax():
    import json

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["after"] == report["before"] == [], report
    # the walk reached the whole package
    for name in ("ifseg_torch.eval.serving", "ifseg_torch.ops.flash_attention",
                 "ifseg_torch.ops.histogram", "ifseg_torch.train.trainer",
                 "ifseg_torch.train.criterion", "ifseg_torch.train.optim",
                 "ifseg_torch.train.ema", "ifseg_torch.data.artificial",
                 "ifseg_torch.tools.profile_training", "ifseg_torch.ops.layer_norm",
                 "ifseg_torch.eval.evaluator", "ifseg_torch.data.segmentation_dataset",
                 "ifseg_torch.tools.profile_eval", "ifseg_torch.cli.validate",
                 "ifseg_torch.data.png", "ifseg_torch.data.transforms",
                 "ifseg_torch.data.file_dataset", "ifseg_torch.tasks.segmentation",
                 "ifseg_torch.utils.metrics",
                 "ifseg_torch.tokenization.gpt2_bpe", "ifseg_torch.tokenization.bert_bpe",
                 "ifseg_torch.tokenization.dictionary", "ifseg_torch.checkpoint.convert",
                 "ifseg_torch.cli.train", "ifseg_torch.checkpoint.manager",
                 "ifseg_torch.data.iterators", "ifseg_torch.utils.progress",
                 "ifseg_torch.ops.crf", "ifseg_torch.ops.crf_device",
                 "ifseg_torch.ops.quantization", "ifseg_torch.cli.serve",
                 "ifseg_torch.cli.infer", "ifseg_torch.data.jpeg", "ifseg_torch.data.image",
                 "ifseg_torch.cli.convert_dataset", "ifseg_torch.cli.score",
                 "ifseg_torch.utils.scoring", "ifseg_torch.benchmark.dummy_seg",
                 "ifseg_torch.ops.gelu", "ifseg_torch.models.ar_cache",
                 "ifseg_torch.ops.ngram_block", "ifseg_torch.generate",
                 "ifseg_torch.generate.search", "ifseg_torch.generate.sequence_generator",
                 "ifseg_torch.generate.trie", "ifseg_torch.generate.lexical",
                 "ifseg_torch.data.jpeg2000", *NEW_MODULES):
        assert name in report["modules"], name


# the modules that completed the port of every JAX module
NEW_MODULES = ("ifseg_torch.utils.profiling", "ifseg_torch.utils.tb_events",
               "ifseg_torch.tasks.registry", "ifseg_torch.models.lightconv")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_the_module_alone_loads_no_jax(module):
    """Each imported alone in a fresh interpreter pulls in nothing of
    ``FORBIDDEN``."""
    code = ("import importlib, json, sys; importlib.import_module(%r); "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in %r)))"
            % (module, FORBIDDEN))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_no_port_module_imports_the_orbax_tool():
    """``tools/orbax_to_torch.py`` imports JAX and orbax: no module of the
    port, nor ``chip_smoke.py``, may import it (or anything of ``tools``)."""
    tool = REPO / "tools" / "orbax_to_torch.py"
    assert "import orbax.checkpoint" in tool.read_text()
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            assert not any(n.split(".")[0] in ("tools", "orbax_to_torch")
                           or n.endswith("orbax_to_torch") for n in names), path
        assert "orbax_to_torch" not in path.read_text().replace(
            "tools/orbax_to_torch.py", ""), path


def _sources():
    files = sorted((REPO / "ifseg_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_the_scan_covers_the_evaluation_slice():
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    for path in ("ifseg_torch/ops/layer_norm.py", "ifseg_torch/eval/evaluator.py",
                 "ifseg_torch/data/segmentation_dataset.py",
                 "ifseg_torch/tools/profile_eval.py", "chip_smoke.py",
                 "ifseg_torch/cli/validate.py", "ifseg_torch/data/png.py",
                 "ifseg_torch/data/transforms.py", "ifseg_torch/tokenization/gpt2_bpe.py",
                 "ifseg_torch/utils/metrics.py", "ifseg_torch/tasks/segmentation.py",
                 "ifseg_torch/cli/train.py", "ifseg_torch/checkpoint/manager.py",
                 "ifseg_torch/data/iterators.py", "ifseg_torch/utils/progress.py",
                 "ifseg_torch/train/trainer.py", "ifseg_torch/ops/crf.py",
                 "ifseg_torch/ops/crf_device.py", "ifseg_torch/ops/quantization.py",
                 "ifseg_torch/cli/serve.py", "ifseg_torch/cli/infer.py",
                 "ifseg_torch/data/jpeg.py", "ifseg_torch/data/image.py",
                 "ifseg_torch/cli/convert_dataset.py", "ifseg_torch/cli/score.py",
                 "ifseg_torch/utils/scoring.py", "ifseg_torch/benchmark/dummy_seg.py",
                 "ifseg_torch/ops/gelu.py", "ifseg_torch/models/ar_cache.py",
                 "ifseg_torch/ops/ngram_block.py", "ifseg_torch/generate/__init__.py",
                 "ifseg_torch/generate/search.py", "ifseg_torch/generate/sequence_generator.py",
                 "ifseg_torch/generate/trie.py", "ifseg_torch/generate/lexical.py",
                 *(m.replace(".", "/") + ".py" for m in NEW_MODULES)):
        assert path in scanned, path


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            found.append(str(node.args[0].value))
    bad = [m for m in found if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


BUILD_SCRIPT = r"""
import json, pathlib, subprocess, sys, tempfile
calls = []
popen_init = subprocess.Popen.__init__
def spy(self, args, *a, **k):
    calls.append([str(x) for x in args])
    return popen_init(self, args, *a, **k)
subprocess.Popen.__init__ = spy
import ifseg_torch.data.png as png
import ifseg_torch.cli.validate
at_import = len(calls)
from ifseg_torch.ops import build
build.BUILD_DIR = pathlib.Path(tempfile.mkdtemp())  # nothing built there yet
from chip_smoke import png_bytes
import numpy as np
arr = np.arange(12, dtype=np.uint8).reshape(3, 4)
ok = bool((png.decode_png(png_bytes(arr, 0)) == arr).all())
png.decode_png(png_bytes(arr, 0))
built = sorted(p.name for p in build.BUILD_DIR.iterdir())
print(json.dumps({"at_import": at_import, "calls": calls, "ok": ok, "built": built}))
"""

JPEG_BUILD_SCRIPT = r"""
import json, pathlib, subprocess, tempfile
calls = []
popen_init = subprocess.Popen.__init__
def spy(self, args, *a, **k):
    calls.append([str(x) for x in args])
    return popen_init(self, args, *a, **k)
subprocess.Popen.__init__ = spy
import ifseg_torch.data.jpeg as jpeg
import ifseg_torch.data.image
import ifseg_torch.cli.convert_dataset
at_import = len(calls)
from ifseg_torch.ops import build
build.BUILD_DIR = pathlib.Path(tempfile.mkdtemp())  # nothing built there yet
import numpy as np
arr = np.full((9, 14, 3), 90, np.uint8)
ok = bool((jpeg.decode_jpeg(jpeg.encode_jpeg(arr, 95, 0)).astype(int) - 90).__abs__().max() <= 2)
built = sorted(p.name for p in build.BUILD_DIR.iterdir())
print(json.dumps({"at_import": at_import, "calls": calls, "ok": ok, "built": built}))
"""


def test_importing_the_png_decoder_starts_no_compiler():
    import json

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", BUILD_SCRIPT], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["at_import"] == 0, report
    # the first decode built png_unfilter.cpp with the host compiler, once
    assert report["ok"] and len(report["calls"]) == 1, report
    assert report["calls"][0][-1].endswith("csrc/png_unfilter.cpp"), report
    assert any(name.startswith("libpng_unfilter-") and name.endswith(".so")
               for name in report["built"]), report


def test_importing_the_jpeg_codec_starts_no_compiler():
    """Importing the JPEG codec and its users starts no compiler; the first
    encode and the first decode build their own host C++ source, once each."""
    import json

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", JPEG_BUILD_SCRIPT], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["at_import"] == 0, report
    assert report["ok"] and len(report["calls"]) == 2, report
    assert [c[-1].rsplit("/", 1)[-1] for c in report["calls"]] == ["jpeg_encode.cpp",
                                                                 "jpeg_decode.cpp"], report
    assert sum(n.endswith(".so") for n in report["built"]) == 2, report


JPEG2000_BUILD_SCRIPT = r"""
import json, pathlib, subprocess, tempfile
calls = []
popen_init = subprocess.Popen.__init__
def spy(self, args, *a, **k):
    calls.append([str(x) for x in args])
    return popen_init(self, args, *a, **k)
subprocess.Popen.__init__ = spy
import ifseg_torch.data.jpeg2000 as jpeg2000
import ifseg_torch.data.image as image
import ifseg_torch.cli.serve
at_import = len(calls)
from ifseg_torch.ops import build
build.BUILD_DIR = pathlib.Path(tempfile.mkdtemp())  # nothing built there yet
data = pathlib.Path("tests/torch_image_files/j2k_l_45x37.j2k").read_bytes()
pixels, mode, _ = image.decode_image(data)
jpeg2000.decode_jpeg2000_rgb(data)
built = sorted(p.name for p in build.BUILD_DIR.iterdir())
print(json.dumps({"at_import": at_import, "calls": calls, "ok": [mode, list(pixels.shape)],
                  "built": built}))
"""


def test_importing_the_jpeg2000_decoder_starts_no_compiler():
    """Importing the JPEG 2000 decoder and its users starts no compiler; the
    first decode builds ``csrc/jpeg2000_decode.cpp``, once."""
    import json

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", JPEG2000_BUILD_SCRIPT], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["at_import"] == 0, report
    assert report["ok"] == ["L", [37, 45]] and len(report["calls"]) == 1, report
    assert report["calls"][0][-1].endswith("csrc/jpeg2000_decode.cpp"), report
    assert [n for n in report["built"] if n.endswith(".so")] == [
        n for n in report["built"] if n.startswith("libjpeg2000_decode-") and n.endswith(".so")]
    assert len([n for n in report["built"] if n.endswith(".so")]) == 1, report


def _loads_a_library(node) -> bool:
    """A call of ``ctypes.CDLL``/``PyDLL``/``WinDLL``, ``ctypes.cdll.*``,
    ``cdll.LoadLibrary`` or ``ctypes.util.find_library``."""
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    names = []
    while isinstance(func, ast.Attribute):
        names.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        names.append(func.id)
    return bool({"CDLL", "PyDLL", "WinDLL", "cdll", "pydll", "LoadLibrary",
                 "find_library"} & set(names))


@pytest.mark.parametrize("path", sorted((REPO / "ifseg_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_library_is_loaded_outside_the_build_module(path):
    """The port loads no system or wheel-bundled library (PIL's wheel ships
    libwebp, libjpeg ...): only ``ops/build.py`` calls ``ctypes.CDLL``, on
    what it built into a checkout's ``_build/``."""
    calls = [node.lineno for node in ast.walk(ast.parse(path.read_text(), filename=str(path)))
             if _loads_a_library(node)]
    if path.relative_to(REPO).as_posix() == "ifseg_torch/ops/build.py":
        assert len(calls) == 2, calls  # load() and load_built()
    else:
        assert not calls, f"{path.name} loads a library at lines {calls}"


def test_load_built_takes_only_built_libraries(tmp_path):
    from ifseg_torch.ops import build

    for bad in ("/usr/lib/x86_64-linux-gnu/libwebp.so", tmp_path / "libx.so",
                tmp_path / "_build" / "x.so"):
        with pytest.raises(ValueError, match="_build"):
            build.load_built(bad)
