"""The CUDA build's cache key: a library's name hashes its ``.cu`` source, every shared header
``csrc/*.cuh`` and the flags, so an edited header rebuilds every library that may include it.
Runs on a copy of ``ops/csrc`` and needs no nvcc."""
import shutil

from blackbox_mpc_torch.ops import _build


def test_target_hashes_source_headers_and_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("rollout", "fused_cem")
    before = {name: _build._target(name) for name in names}
    assert before["rollout"] != before["fused_cem"]
    assert {name: _build._target(name) for name in names} == before  # stable

    header = csrc / "mlp_step.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after_header = {name: _build._target(name) for name in names}
    assert all(after_header[name] != before[name] for name in names)

    (csrc / "rollout.cu").write_bytes((csrc / "rollout.cu").read_bytes() + b"\n")
    assert _build._target("rollout") != after_header["rollout"]
    assert _build._target("fused_cem") == after_header["fused_cem"]

    (csrc / "extra.cuh").write_text("// a new header\n")
    assert _build._target("fused_cem") != after_header["fused_cem"]

    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._target("rollout") != after_header["rollout"]


def test_build_skips_libraries_already_built(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    for name in ("rollout", "fused_cem"):
        _build._target(name).write_bytes(b"")
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(AssertionError("nvcc")))
    assert _build.build("rollout", "fused_cem") == {"rollout": "", "fused_cem": ""}
