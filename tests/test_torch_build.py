"""The kernel build of the port (``ops/cuda/_build.py``) without a compiler.

A stand-in ``nvcc`` (a Python script that records its arguments and writes
its ``-o`` file) shows the flow: one compile per ``csrc`` source with the
sm_90a flags, then one link into the shared library named by the sources'
hash; an unchanged tree reuses the library, a changed source builds anew,
and a failing compile raises with its output instead of falling back.
"""

import json
import sys

import pytest

from volpick_tpu_torch.ops.cuda import _build

FAKE_NVCC = """\
import json, os, sys
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps(args) + "\\n")
if any(a.endswith("bad.cu") for a in args):
    print("bad.cu(1): error: expected a declaration")
    sys.exit(2)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
"""


@pytest.fixture()
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text(f"// {name}\n")
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\n{FAKE_NVCC}")
    script.chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))

    def calls():
        return [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []

    return csrc, calls


def test_one_compile_per_source_then_one_link(fake_tree):
    csrc, calls = fake_tree
    lib = _build.build()
    assert lib.exists() and lib == _build.library_path()
    compiles = [c for c in calls() if "-c" in c]
    links = [c for c in calls() if "-shared" in c]
    assert sorted(c[-1].rsplit("/", 1)[-1] for c in compiles) == ["a.cu", "b.cu", "c.cu"]
    for c in compiles:
        assert "arch=compute_90a,code=sm_90a" in c and "-O3" in c and "--use_fast_math" not in c
    assert len(links) == 1 and len([a for a in links[0] if a.endswith(".o")]) == 3
    assert not list(lib.parent.glob("*.o"))  # objects are removed after the link

    n = len(calls())
    assert _build.build() == lib and len(calls()) == n  # unchanged sources: no build
    (csrc / "b.cu").write_text("// b.cu, changed\n")
    assert _build.library_path() != lib
    assert _build.build().exists() and len(calls()) > n


def test_failed_compile_raises_with_output(fake_tree):
    csrc, _ = fake_tree
    (csrc / "bad.cu").write_text("nonsense\n")
    with pytest.raises(RuntimeError, match="expected a declaration"):
        _build.build()
    assert "bad.cu" in _build.build_log
    assert not _build.library_path().exists()
