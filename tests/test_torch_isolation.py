"""The port stands alone: nothing under ``cpzk_tpu_torch/`` (nor
``chip_smoke.py``) imports ``jax`` or ``cpzk_tpu``, importing the package
(its gRPC service, state store, wire parse and protobuf bindings included)
pulls in neither and puts no top-level ``auth_pb2``/``health_pb2`` module in
``sys.modules``, the host core (the request-wire parser included) is built
from the port's own sources, the GPU entry point refuses to run without
CUDA unless the caller asks for the CPU, and the daemon and a started
ingest shard pull in neither (the shard not torch's CUDA either)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "cpzk_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
#: top-level module names the port never imports: JAX, the JAX package,
#: and the reference's protobuf modules as it puts them on ``sys.path``
FORBIDDEN = ("jax", "jaxlib", "cpzk_tpu", "auth_pb2", "health_pb2", "replication_pb2")


def imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_no_file_imports_jax_or_the_jax_package():
    assert len(PORT_FILES) > 10
    offenders = {}
    for path in PORT_FILES:
        bad = sorted(m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN)
        if bad:
            offenders[str(path.relative_to(ROOT))] = bad
    assert offenders == {}


def test_import_pulls_in_neither_jax_nor_cpzk_tpu():
    code = (
        "import sys\n"
        "import cpzk_tpu_torch, cpzk_tpu_torch.convert\n"
        "import cpzk_tpu_torch.ops.backend, cpzk_tpu_torch.ops.verify\n"
        "import cpzk_tpu_torch.ops.sclimbs, cpzk_tpu_torch.ops.scalar_kernels\n"
        "import cpzk_tpu_torch.ops.msm, cpzk_tpu_torch.ops.msm_kernels\n"
        "import cpzk_tpu_torch.ops.prove, cpzk_tpu_torch.ops.prove_kernels\n"
        "import cpzk_tpu_torch.ops.keccak, cpzk_tpu_torch.ops.keccak_kernels\n"
        "import cpzk_tpu_torch.ops.challenge\n"
        "import cpzk_tpu_torch.server, cpzk_tpu_torch.server.plane\n"
        "import cpzk_tpu_torch.observability, cpzk_tpu_torch.resilience.faults\n"
        "import cpzk_tpu_torch.parallel\n"
        "from cpzk_tpu_torch.server import build_backend, DynamicBatcher\n"
        "import cpzk_tpu_torch.server.service, cpzk_tpu_torch.server.state\n"
        "import cpzk_tpu_torch.server.wire, cpzk_tpu_torch.server.proto\n"
        "import cpzk_tpu_torch.observability.instrument\n"
        "import cpzk_tpu_torch.admission, cpzk_tpu_torch.resilience.retry\n"
        "import cpzk_tpu_torch.durability.wal, cpzk_tpu_torch.durability.recovery\n"
        "from cpzk_tpu_torch.durability import DurabilityManager, WriteAheadLog\n"
        "from cpzk_tpu_torch.server import RateLimiter, ServerState, UserData\n"
        "cpzk_tpu_torch.server.proto.load_pb2(), cpzk_tpu_torch.server.proto.load_health_pb2()\n"
        "cpzk_tpu_torch.server.proto.load_replication_pb2()\n"
        "import cpzk_tpu_torch.replication, cpzk_tpu_torch.fleet.split\n"
        "import cpzk_tpu_torch.fleet.__main__\n"
        "import cpzk_tpu_torch.parallel.mesh, cpzk_tpu_torch.parallel.multihost\n"
        "import cpzk_tpu_torch.server.router, cpzk_tpu_torch.fleet.controller\n"
        "import cpzk_tpu_torch.observability.regress\n"
        "import cpzk_tpu_torch.ops.decode_kernels\n"
        "import cpzk_tpu_torch.analysis, cpzk_tpu_torch.analysis.model\n"
        "import cpzk_tpu_torch.analysis.__main__, cpzk_tpu_torch.analysis.rules\n"
        "cpzk_tpu_torch.analysis.analyze_source('x = 1\\n')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cpzk_tpu')]\n"
        "assert not bad, bad\n"
        "top = [m for m in sys.modules if m in ('auth_pb2', 'health_pb2', 'replication_pb2')]\n"
        "assert not top, top\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_importing_parallel_initializes_neither_cuda_nor_a_process_group():
    """``import cpzk_tpu_torch.parallel`` (and resolving its lazy mesh
    names) leaves CUDA and ``torch.distributed`` uninitialized, so
    ``multihost.initialize`` can always run after it."""
    code = (
        "import torch, torch.distributed as dist\n"
        "import cpzk_tpu_torch.parallel as par\n"
        "from cpzk_tpu_torch.parallel import multihost\n"
        "assert par.Mesh and par.batch_mesh and par.make_sharded_verify_each\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not (dist.is_available() and dist.is_initialized())\n"
        "assert multihost.process_info() == (0, 1)\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_torch_backend_needs_cuda_unless_asked_for_cpu(monkeypatch):
    from cpzk_tpu_torch.ops.backend import TorchBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBackend()
    assert TorchBackend(device="cpu").device == torch.device("cpu")


def test_prover_and_device_challenges_need_cuda_unless_asked_for_cpu(monkeypatch):
    """``BatchProver`` and ``derive_challenges_device`` run on cuda:0 by
    default and raise without CUDA; the plain versions run only when the
    caller passes ``device="cpu"``."""
    import numpy as np

    from cpzk_tpu_torch.ops.challenge import derive_challenges_device
    from cpzk_tpu_torch.ops.prove import BatchProver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchProver()
    cols = [np.zeros((1, 32), dtype=np.uint8)] * 6
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        derive_challenges_device(None, *cols)
    assert derive_challenges_device(None, *cols, device="cpu").shape == (1, 64)


def test_batch_verifier_defaults_to_the_card(monkeypatch):
    from cpzk_tpu_torch import BatchVerifier, CpuBackend
    from cpzk_tpu_torch.ops.backend import TorchBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchVerifier()
    assert isinstance(BatchVerifier(backend=CpuBackend()).backend, CpuBackend)
    cpu = TorchBackend(device="cpu")
    assert BatchVerifier(backend=cpu).backend is cpu


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    """Without a card, or run outside the repository, the script exits
    non-zero and prints no result line."""
    env_code = "import torch; torch.cuda.is_available = lambda: False; "
    res = subprocess.run(
        [sys.executable, "-c", env_code + "import runpy, sys; sys.argv = ['chip_smoke.py']; "
         "runpy.run_path('chip_smoke.py', run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_native_core_builds_only_from_the_port_sources():
    """The host core is compiled from ``cpzk_tpu_torch/native`` into the
    port's ``_build``, and loading it maps nothing of ``cpzk_tpu/_lib``."""
    from cpzk_tpu_torch.core import _native

    assert {src.parent for src in _native.SOURCES} == {ROOT / "cpzk_tpu_torch" / "native"}
    assert {src.name for src in _native.SOURCES} == {"merlin.cpp", "ristretto.cpp", "wire.cpp"}
    assert _native.BUILD_DIR == ROOT / "cpzk_tpu_torch" / "_build"
    code = (
        "from cpzk_tpu_torch.core import _native\n"
        "import cpzk_tpu_torch as T\n"
        "T.Proof.from_bytes_batch([bytes(109)])\n"
        "assert _native.wire_index(_native.WIRE_CHALLENGE, b'\\x0a\\x01u') is not None\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'cpzk_tpu/_lib' not in maps and 'libcpzk_native' not in maps\n"
        "assert str(_native.build()) in maps\n"
        "print(_native.build())\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    path = Path(res.stdout.strip())
    assert path.parent == ROOT / "cpzk_tpu_torch" / "_build"
    assert path.name.startswith("libcpzk_host_")


def test_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A compiler that fails makes the build, and the first use of the core,
    raise with its output in the message: there is no fallback."""
    from cpzk_tpu_torch.core import _native

    with pytest.raises(_native.NativeCoreError, match="build failed"):
        _native.build(cxx="false", out_dir=tmp_path)
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'fake-cxx: no such target' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_native, "CXX", str(fake))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_LIB", None)
    with pytest.raises(_native.NativeCoreError, match="(?s)failed \\(3\\).*no such target"):
        _native.load()
    from cpzk_tpu_torch.core.transcript import Transcript

    with pytest.raises(_native.NativeCoreError):
        Transcript()
    assert not list((tmp_path / "build").glob("*.so"))


def test_concurrent_first_builds_yield_one_loadable_library(tmp_path):
    """Processes that build at once (as test workers do) all get the same
    complete library, and only one is written."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from cpzk_tpu_torch.core import _native\n"
        "path = _native.build(out_dir=Path(sys.argv[1]))\n"
        "lib = _native.open_library(path)\n"
        "assert lib.cpzk_abi_version() == _native.ABI_VERSION\n"
        "print(path)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [err for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    assert [p.name for p in tmp_path.glob("*.so")] == [Path(outs[0][0].strip()).name]
    assert not list(tmp_path.glob("*.tmp"))


_DAEMON_SCRIPT = """
import asyncio, signal, sys
import cpzk_tpu_torch.server.__main__ as daemon

args = daemon.parse_args(["--no-repl", "--port", "0"])

async def main():
    loop = asyncio.get_running_loop()
    task = loop.create_task(daemon.amain(args, device="cpu"))
    deadline = loop.time() + 60.0
    while signal.getsignal(signal.SIGTERM) is signal.SIG_DFL:
        if task.done():
            await task
        assert loop.time() < deadline, "daemon never listened"
        await asyncio.sleep(0.05)
    signal.raise_signal(signal.SIGTERM)
    await task

asyncio.run(main())
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cpzk_tpu')]
assert not bad, bad
assert "cpzk_tpu_torch.ops.backend" in sys.modules  # it served the card's path
assert "cpzk_tpu_torch.admission.controller" in sys.modules  # admission on by default
print("DAEMON-ISOLATED")
"""


@pytest.mark.parametrize("durability", [False, True])
def test_daemon_boot_pulls_in_neither_jax_nor_cpzk_tpu(tmp_path, durability):
    """``cpzk_tpu_torch.server.__main__``, booted on the card's path (the
    kernels' plain versions here) with admission on (the default), with
    and without ``[durability]``, and stopped, imports no JAX and nothing
    of the JAX package."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
    env["SERVER_CONFIG_PATH"] = str(tmp_path / "none.toml")
    if durability:
        env.update(SERVER_DURABILITY_ENABLED="1", SERVER_STATE_FILE=str(tmp_path / "s.json"))
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _DAEMON_SCRIPT], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "DAEMON-ISOLATED" in res.stdout


_SHARD_SCRIPT = """
import asyncio, json, socket, sys, time
sys.path.insert(0, sys.argv[2])
import grpc
import torch_shard_probe
from cpzk_tpu_torch.protocol.batch import CpuBackend
from cpzk_tpu_torch.server import ingest
from cpzk_tpu_torch.server.config import RateLimiter
from cpzk_tpu_torch.server.service import serve
from cpzk_tpu_torch.server.state import ServerState

out = sys.argv[1]

async def main():
    server, _ = await serve(ServerState(), RateLimiter(10**6, 10**6), port=0,
                            backend=CpuBackend(), listen=False)
    s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
    sup = ingest.IngestSupervisor(server.auth_service, server.health, shards=2,
                                  host="127.0.0.1", port=port)
    def spawn(index):  # the supervisor's spawn, with the probe as the target
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        proc = ctx.Process(target=torch_shard_probe.probe_shard, args=(
            index, sup.uds_path, {"host": sup.host, "port": sup.port,
                                  "wire": sup.wire, "tls": None, "probe_out": out}),
            daemon=True)
        proc.start()
        sup._procs[index] = proc
        sup.shard_stats[index]["pid"] = proc.pid
    sup._spawn = spawn
    await sup.start()
    try:
        deadline = time.monotonic() + 30
        while not all(r["connected"] for r in sup.shard_stats.values()):
            assert time.monotonic() < deadline, sup.status()
            await asyncio.sleep(0.1)
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            call = ch.unary_unary("/auth.AuthService/CreateChallenge")
            for _ in range(4):  # spread over the shards' connections
                try:
                    await call(b"\\x0a\\x06nobody")
                except grpc.RpcError as err:
                    assert err.code() is not grpc.StatusCode.UNAVAILABLE, err
        assert sum(r["parses"] for r in sup.shard_stats.values()) >= 1, sup.status()
    finally:
        await sup.stop()
        await server.stop(None)

asyncio.run(main())
print("SHARD-PROBED")
"""


def test_started_ingest_shard_imports_no_jax_and_never_touches_cuda(tmp_path):
    """A spawned, connected and serving ingest shard of the port has no
    JAX, nothing of the JAX package, and no CUDA context in it."""
    out = tmp_path / "probe"
    res = subprocess.run(
        [sys.executable, "-c", _SHARD_SCRIPT, str(out), str(ROOT / "tests")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "SHARD-PROBED" in res.stdout
    reports = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("probe.*"))]
    assert len(reports) == 2
    for doc in reports:
        assert doc["ingest_loaded"]
        assert doc["modules"] == []
        assert doc["cuda_initialized"] is False
        assert doc["torch_imported"] is False  # the shard's path needs no torch
