"""The port stands alone: every module of vistaocr_tpu_torch imports with
jax, jaxlib, flax, optax, PIL and msgpack blocked and pulls in nothing of
the JAX package (and so does each offline-inference and host-decoding
module on its own); its copies of the text codec, alphabet and bidi modules
agree with the JAX package's; and chip_smoke.py refuses to run (non-zero
exit, no result line) where there is no CUDA device."""

import json
import os
import subprocess
import sys

import pytest

import vistaocr_tpu.text as jax_text
from vistaocr_tpu.text.bidi import display_order as jax_display_order

import vistaocr_tpu_torch.text as port_text
from vistaocr_tpu_torch.text.bidi import display_order

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "PIL", "msgpack"):
    sys.modules[name] = None
import importlib, pkgutil
import vistaocr_tpu_torch
names = ["vistaocr_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(vistaocr_tpu_torch.__path__,
                                          "vistaocr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "vistaocr_tpu" or m.startswith("vistaocr_tpu."))
print(len(names), leaked)
assert not leaked, leaked
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_every_module_imports_without_jax_pil_or_msgpack():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS],
                          capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 20, proc.stdout


_HOST_MODULES = ("vistaocr_tpu_torch.infer", "vistaocr_tpu_torch.decode.beam",
                 "vistaocr_tpu_torch.decode.lm",
                 "vistaocr_tpu_torch.decode.lexicon",
                 "vistaocr_tpu_torch.decode.native_binding",
                 "vistaocr_tpu_torch.decode.offline",
                 "vistaocr_tpu_torch.data.transforms",
                 "vistaocr_tpu_torch.serve.service")


def test_host_modules_import_without_jax_or_pil():
    """The offline-inference and host-decoding modules in a fresh
    interpreter with jax, flax, optax and PIL blocked: none of them, and
    nothing of the JAX package, is imported."""
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'flax', 'optax', 'PIL'):\n"
        "    sys.modules[n] = None\n"
        "import importlib\n"
        f"for name in {_HOST_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('vistaocr_tpu', 'jax', 'flax', 'optax', 'PIL')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("text", ["Ab c", "سلام 12.5 world", "x\U0001f600y",
                                  ""])
def test_text_copies_agree(text):
    u = port_text.utf8_to_uxxxx(text)
    assert u == jax_text.utf8_to_uxxxx(text)
    assert port_text.uxxxx_to_utf8(u) == jax_text.uxxxx_to_utf8(u) == text
    assert display_order(text) == jax_display_order(text)


def test_alphabet_json_agrees():
    chars = "".join(chr(c) for c in range(0x20, 0x7F)) + "سلام"
    ours = port_text.Alphabet.from_charset(chars)
    theirs = jax_text.Alphabet.from_charset(chars)
    assert ours.to_json() == theirs.to_json()
    back = port_text.Alphabet.from_json(theirs.to_json())
    assert back.tokens == theirs.tokens
    ids = theirs.encode(port_text.utf8_to_uxxxx("Hello"))
    assert ours.decode(ids) == theirs.decode(ids)
    assert json.loads(ours.to_json())["blank_index"] == 0
