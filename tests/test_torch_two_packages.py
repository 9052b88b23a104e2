"""Both packages' gRPC services in one process.

A pytest-xdist worker may load the reference's service and the port's in
either order, so three process-wide names must not collide: the protobuf
descriptor pool (both register the file ``auth.proto``; the default pool
accepts a second copy only when its serialized bytes are identical), the
top-level ``auth_pb2`` module the reference puts on ``sys.path`` (the port
imports ``cpzk_tpu_torch._gen.auth_pb2`` by that name only), and
prometheus_client's default registry (the port's metrics live in its own
``PROM_REGISTRY``).  Each order runs in a fresh process: both servers
start, answer a register and a challenge from one client each, and the
checks below hold.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = """
import asyncio, sys
sys.path.insert(0, {root!r})
order = {order!r}
if order == "reference-first":
    from cpzk_tpu.server import service as jsvc
    from cpzk_tpu_torch.server import service as tsvc
else:
    from cpzk_tpu_torch.server import service as tsvc
    from cpzk_tpu.server import service as jsvc
import prometheus_client
import cpzk_tpu as J
from cpzk_tpu.client import AuthClient
from cpzk_tpu.server import RateLimiter as JRL, ServerState as JSS
from cpzk_tpu.server.proto import load_pb2 as j_load
from cpzk_tpu_torch import CpuBackend
from cpzk_tpu_torch.server import RateLimiter as TRL, ServerState as TSS, metrics
from cpzk_tpu_torch.server.proto import load_pb2 as t_load
from cpzk_tpu_torch._gen import auth_pb2, health_pb2
from cpzk_tpu.server.proto import load_replication_pb2 as j_load_repl
from cpzk_tpu_torch.server.proto import load_replication_pb2 as t_load_repl

jpb, tpb = j_load(), t_load()
assert tpb is auth_pb2 and tpb.__name__ == "cpzk_tpu_torch._gen.auth_pb2"
assert jpb.__name__ == "auth_pb2"
assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
assert health_pb2.__name__ == "cpzk_tpu_torch._gen.health_pb2"
# replication.proto joins the descriptors both packages register
jrepl, trepl = j_load_repl(), t_load_repl()
assert trepl.__name__ == "cpzk_tpu_torch._gen.replication_pb2" and jrepl.__name__ == "replication_pb2"
assert trepl.DESCRIPTOR.serialized_pb == jrepl.DESCRIPTOR.serialized_pb

async def main():
    rng = J.SecureRng()
    eb = J.Ristretto255.element_to_bytes
    out = []
    for serve, state, rl, kw in (
            (jsvc.serve, JSS(), JRL(10**6, 10**6), {{}}),
            (tsvc.serve, TSS(), TRL(10**6, 10**6), {{"backend": CpuBackend()}})):
        server, port = await serve(state, rl, host="127.0.0.1", port=0, **kw)
        try:
            async with AuthClient(f"127.0.0.1:{{port}}") as c:
                st = J.Prover(J.Parameters.new(), J.Witness(J.Ristretto255.random_scalar(rng))).statement
                r = await c.register("both", eb(st.y1), eb(st.y2))
                ch = await c.create_challenge("both")
                out.append((r.success, r.message, len(ch.challenge_id)))
        finally:
            await server.stop(None)
    return out

ref, port = asyncio.run(main())
assert ref == port == (True, "User 'both' registered successfully", 32), (ref, port)
# the port's metric families live only in its own registry
assert metrics.read("auth.register.success") == 1.0
port_names = set(metrics.PROM_REGISTRY._names_to_collectors)
assert "auth_register_success_total" in port_names
for kind, name in metrics.registered():
    m = metrics._REGISTRY[f"{{kind}}:{{name}}"]
    assert m in metrics.PROM_REGISTRY._collector_to_names, name
    assert m not in prometheus_client.REGISTRY._collector_to_names, name
# the reference counted its own register once, in the default registry
assert prometheus_client.REGISTRY.get_sample_value("auth_register_success_total") == 1.0
print("TWO-PACKAGES-OK")
"""


@pytest.mark.parametrize("order", ["reference-first", "port-first"])
def test_both_services_in_one_process(order):
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(root=str(ROOT), order=order)],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "TWO-PACKAGES-OK" in res.stdout


def test_port_descriptor_is_protoc_output_with_the_reference_order(tmp_path):
    """The port's committed ``auth_pb2`` and ``replication_pb2`` carry the
    reference's serialized descriptors (byte-equal), and those descriptors
    hold exactly what protoc makes of ``proto/auth.proto`` and
    ``proto/replication.proto``, message for message."""
    from google.protobuf import descriptor_pb2

    import cpzk_tpu_torch._gen.auth_pb2 as port_pb2
    import cpzk_tpu_torch._gen.health_pb2 as port_health
    import cpzk_tpu_torch._gen.replication_pb2 as port_repl

    ref_src = (ROOT / "cpzk_tpu" / "_gen" / "auth_pb2.py").read_text()
    assert repr(port_pb2.DESCRIPTOR.serialized_pb) in ref_src
    # the replication module's descriptor is the reference's, byte for byte
    from cpzk_tpu.server.proto import load_replication_pb2

    assert port_repl.DESCRIPTOR.serialized_pb == load_replication_pb2().DESCRIPTOR.serialized_pb
    protoc = shutil.which("protoc")
    if protoc is None:
        pytest.skip("protoc is not installed")
    out = tmp_path / "desc.pb"
    subprocess.run([protoc, f"-I{ROOT / 'proto'}", f"--descriptor_set_out={out}",
                    "auth.proto", "health.proto", "replication.proto"], check=True,
                   timeout=60)
    fds = descriptor_pb2.FileDescriptorSet.FromString(out.read_bytes())
    made = {f.name: f for f in fds.file}
    for f in made.values():  # a descriptor set adds json names; modules omit them
        for m in f.message_type:
            for fd in m.field:
                fd.ClearField("json_name")
    port = descriptor_pb2.FileDescriptorProto.FromString(port_pb2.DESCRIPTOR.serialized_pb)
    want = made["auth.proto"]
    assert sorted(m.SerializeToString() for m in port.message_type) == sorted(
        m.SerializeToString() for m in want.message_type)
    del port.message_type[:]
    del want.message_type[:]
    assert port.SerializeToString() == want.SerializeToString()
    assert port_health.DESCRIPTOR.serialized_pb == made["health.proto"].SerializeToString()
    # the committed replication descriptor (the reference's bytes) lists its
    # messages in another order and names one field's json name: the same
    # messages and service as protoc's
    repl = descriptor_pb2.FileDescriptorProto.FromString(port_repl.DESCRIPTOR.serialized_pb)
    want = made["replication.proto"]
    for m in repl.message_type:
        for fd in m.field:
            fd.ClearField("json_name")
    assert sorted(m.SerializeToString() for m in repl.message_type) == sorted(
        m.SerializeToString() for m in want.message_type)
    del repl.message_type[:]
    del want.message_type[:]
    assert repl.SerializeToString() == want.SerializeToString()
