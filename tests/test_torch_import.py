"""The PyTorch/CUDA port imports neither JAX nor the JAX package, and
importing it registers no codec in either package's registry."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_import_pulls_in_no_jax():
    r = _run("import sys, myyuv_tpu_torch, myyuv_tpu_torch.cli\n"
             "import myyuv_tpu_torch.engine.pipeline\n"
             "import myyuv_tpu_torch.entropy.encode\n"
             "import myyuv_tpu_torch.entropy.decode\n"
             "import myyuv_tpu_torch.kernels.convert\n"
             "import myyuv_tpu_torch.engine.streaming\n"
             "import myyuv_tpu_torch.engine.sweep\n"
             "import myyuv_tpu_torch.entry\n"
             "import myyuv_tpu_torch.tools.rd_sweep\n"
             "import myyuv_tpu_torch.tools.check_bitexact\n"
             "import myyuv_tpu_torch.tools.exp_bcast\n"
             "import myyuv_tpu_torch.tools.exp_fma\n"
             "import myyuv_tpu_torch.tools.exp_r3stage\n"
             "import myyuv_tpu_torch.tools.exp_r4lane\n"
             "import myyuv_tpu_torch.tools.exp_shuffle\n"
             "import myyuv_tpu_torch.tools.exp_sublane\n"
             "import myyuv_tpu_torch.tools.kernel_ab\n"
             "import myyuv_tpu_torch.viewer.export\n"
             "import myyuv_tpu_torch.viewer.terminal\n"
             "bad = [m for m in sys.modules\n"
             "       if m.split('.')[0] in ('jax', 'jaxlib', 'myyuv_tpu')]\n"
             "assert not bad, bad\n"
             "print('OK')")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


def test_import_leaves_both_registries_alone():
    r = _run(
        "import myyuv_tpu\n"
        "from myyuv_tpu.formats import yuv as jy\n"
        "def snap():\n"
        "    return {k: dict(getattr(jy, k)) for k in ('FORMATS',\n"
        "            'BMP_TO_YUV', 'COMPRESSORS', 'DECOMPRESSORS')}\n"
        "before = snap()\n"
        "import myyuv_tpu_torch\n"
        "from myyuv_tpu_torch.engine import pipeline\n"
        "from myyuv_tpu_torch.formats import yuv as ty\n"
        "assert snap() == before\n"
        "assert not ty.BMP_TO_YUV and not ty.COMPRESSORS\n"
        "assert not ty.DECOMPRESSORS\n"
        "pipeline.register_engine_codecs('cpu')\n"
        "assert snap() == before\n"
        "key = (ty.Compressions.DCT, ty.FourccFormats.IYUV)\n"
        "assert key in ty.COMPRESSORS and key in ty.DECOMPRESSORS\n"
        "assert ty.COMPRESSORS[key].func is pipeline.compress_dct\n"
        "print('OK')")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


def test_no_jax_import_lines_in_the_port():
    """No source line of the port or of chip_smoke.py imports JAX or the
    JAX package."""
    import re
    pat = re.compile(r"^\s*(import|from) (jax|jaxlib|myyuv_tpu)([. ]|$)")
    files = sorted((REPO / "myyuv_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits
