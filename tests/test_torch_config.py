"""The port's node configuration files (tool/config.py) and chain builder
(tool/build_chain.py) against the JAX package's (tool/config.py,
tools/build_chain.py): the ini the port writes is the JAX package's, line
for line, plus the port's `[crypto] device` key; the genesis file is byte
equal; a directory either package builds boots in the other's load_node;
an encrypted node.key.enc or node.smtls.enc sealed by either package opens
in the other; both refuse a restart whose genesis file disagrees with the
ledger; the Max-mode entry points raise NotImplementedError.

The nodes run crypto_backend "host" (no suite batch reaches a tensor path).
"""

import dataclasses
import json
import os
import re
import shutil
import sys
import time

import pytest

from fisco_bcos_tpu.executor import precompiled as jpc
from fisco_bcos_tpu.init import node as jnode
from fisco_bcos_tpu.net.gateway import FakeGateway as JFakeGateway
from fisco_bcos_tpu.protocol import Transaction as JTransaction
from fisco_bcos_tpu.tool import config as jconfig
from fisco_bcos_tpu_torch.executor import precompiled as pc
from fisco_bcos_tpu_torch.init import node as pnode
from fisco_bcos_tpu_torch.net.gateway import FakeGateway
from fisco_bcos_tpu_torch.protocol import Transaction
from fisco_bcos_tpu_torch.tool import build_chain as pbuild
from fisco_bcos_tpu_torch.tool import config as pconfig

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import build_chain as jbuild  # noqa: E402  (the JAX package's tools/build_chain.py)

# a value for every string field the ini carries that must stay valid
STRINGS = {"chain_id": "c9", "group_id": "g7", "consensus": "pbft", "seal_mode": "cert",
           "storage_backend": "disk", "storage_path": "/var/chain/d", "crypto_backend": "host",
           "rpc_host": "127.0.0.2", "p2p_host": "127.0.0.3",
           "failpoints": "txpool.submit=off", "compatibility_version": "1.2.0"}


def every_field_set(cls):
    """A config of `cls` whose every field differs from its default."""
    kw = {}
    for f in dataclasses.fields(cls):
        d = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        if f.name in STRINGS:
            kw[f.name] = STRINGS[f.name]
        elif f.name == "groups":
            kw[f.name] = ["g1", "g2"]
        elif f.name == "p2p_peers":
            kw[f.name] = [("127.0.0.1", 30301), ("10.0.0.2", 30302)]
        elif f.name == "device":
            kw[f.name] = "cpu"
        elif isinstance(d, bool):
            kw[f.name] = not d
        elif isinstance(d, int):
            kw[f.name] = d + 3
        elif isinstance(d, float):
            kw[f.name] = d + 0.25
        elif d is None:
            kw[f.name] = 4321
    return cls(**kw)


def jax_twin(cfg):
    """The JAX package's NodeConfig with the port config's fields."""
    names = {f.name for f in dataclasses.fields(jnode.NodeConfig)}
    return jnode.NodeConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def test_node_config_ini_is_the_jax_ini_plus_the_device_key():
    cfg = every_field_set(pnode.NodeConfig)
    port = pconfig.node_config_to_ini(cfg).splitlines()
    jax = jconfig.node_config_to_ini(jax_twin(cfg)).splitlines()
    assert [ln for ln in port if not ln.startswith("device = ")] == jax
    assert port.count("device = cpu") == 1
    # each package reads the port's file back to the fields it wrote
    text = "\n".join(port) + "\n"
    assert pconfig.node_config_to_ini(pconfig.node_config_from_ini(text)) == text
    assert pconfig.node_config_from_ini(text).device == "cpu"
    jtext = "\n".join(jax) + "\n"
    assert jconfig.node_config_to_ini(jconfig.node_config_from_ini(text)) == jtext
    # a JAX-written file has no device key: the port's default, the card
    back = pconfig.node_config_from_ini(jtext)
    assert back.device == "cuda"
    assert pconfig.node_config_to_ini(dataclasses.replace(back, device="cpu")) == text


def test_chain_config_ini_is_byte_equal():
    fields = dict(chain_id="c2", group_id="g3", sm_crypto=True, consensus_type="pbft",
                  block_tx_count_limit=16384, leader_period=2, compatibility_version="1.3.0",
                  sealers=[bytes([i]) * 64 for i in range(1, 5)])
    text = pconfig.ChainConfig(**fields).to_ini()
    assert text == jconfig.ChainConfig(**fields).to_ini()
    assert pconfig.ChainConfig.from_ini(text) == pconfig.ChainConfig(**fields)


def _register(node, suite, kp, tx_cls, encode_call, nonce):
    tx = tx_cls(to=pc.BALANCE_ADDRESS, nonce=nonce,
                input=encode_call("register", lambda w: w.blob(b"cfg").u64(11)),
                block_limit=node.ledger.current_number() + 100).sign(suite, kp)
    return node.send_transaction(tx).tx_hash


def _boot_chain(load_node, gateway, dirs, tx_cls, encode_call):
    """Every directory booted by `load_node` on one in-process gateway;
    a register sent to node 0 commits on all. -> (genesis hashes, node
    ids)."""
    nodes = [load_node(d, gateway=gateway) for d in dirs]
    try:
        for n in nodes:
            n.start()
        lead = nodes[0]
        kp = lead.suite.generate_keypair(b"cfg-user")
        h = _register(lead, lead.suite, kp, tx_cls, encode_call, "cfg-1")
        deadline = time.time() + 60
        while time.time() < deadline and any(n.ledger.current_number() < 1 for n in nodes):
            time.sleep(0.05)
        assert [n.ledger.current_number() for n in nodes] == [1] * len(nodes)
        rc = lead.txpool.wait_for_receipt(h, 10)
        assert rc is not None and rc.status == 0
        return ([n.ledger.header_by_number(0).hash(n.suite) for n in nodes],
                [n.keypair.pub_bytes for n in nodes])
    finally:
        for n in nodes:
            n.stop()
            n.storage.close()
        gateway.stop()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_chain_either_package_builds_boots_in_both(tmp_path, writer):
    build = jbuild.build_chain if writer == "jax" else pbuild.build_chain
    kw = {} if writer == "jax" else {"device": "cpu"}
    info = build(str(tmp_path / "chain"), 4, consensus="pbft", crypto_backend="host", **kw)
    with open(tmp_path / "chain" / "chain_info.json") as f:
        assert json.load(f) == info
    dirs = {}
    for pkg in ("jax", "port"):
        shutil.copytree(tmp_path / "chain", tmp_path / pkg)
        dirs[pkg] = [str(tmp_path / pkg / f"node{i}") for i in range(4)]
    if writer == "port":
        assert "device = cpu" in (tmp_path / "chain" / "node0" / "config.ini").read_text()
    pg, pids = _boot_chain(pconfig.load_node, FakeGateway(), dirs["port"], Transaction,
                           pc.encode_call)
    jg, jids = _boot_chain(jconfig.load_node, JFakeGateway(), dirs["jax"], JTransaction,
                           jpc.encode_call)
    assert pids == jids == [bytes.fromhex(n["node_id"]) for n in info["nodes"]]
    assert len(set(pg)) == 1 and pg == jg


@pytest.mark.parametrize("what", ["node.key.enc", "node.smtls.enc"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_encrypted_file_sealed_by_either_package_opens_in_the_other(tmp_path, writer, what):
    build = jbuild.build_chain if writer == "jax" else pbuild.build_chain
    build(str(tmp_path / "c"), 1, consensus="solo", crypto_backend="host", sm_tls=True,
          encrypt_passphrase=b"hunter2")
    d = str(tmp_path / "c" / "node0")
    assert os.path.exists(os.path.join(d, what))
    assert not os.path.exists(os.path.join(d, what[:-4]))
    if what == "node.key.enc":
        for cfgmod in (pconfig, jconfig):
            with pytest.raises(ValueError, match="passphrase"):
                cfgmod._load_node_parts(d)
        *_, pkp = pconfig._load_node_parts(d, b"hunter2")
        *_, jkp = jconfig._load_node_parts(d, b"hunter2")
        assert pkp.secret == jkp.secret and pkp.pub_bytes == jkp.pub_bytes
    else:
        with pytest.raises(ValueError, match="passphrase"):
            pconfig.load_smtls_context(d)
        pctx = pconfig.load_smtls_context(d, b"hunter2")
        jctx = jconfig.load_smtls_context(d, b"hunter2")
        assert pctx.cred.encode() == jctx.cred.encode()
        assert pctx.ca_pub == jctx.ca_pub and pctx.cred.sign_cert.subject == "node0"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_genesis_mismatch_is_refused_on_restart(tmp_path, pkg):
    cfgmod = jconfig if pkg == "jax" else pconfig
    pbuild.build_chain(str(tmp_path / "g"), 1, consensus="solo", crypto_backend="host",
                       device="cpu")
    d = str(tmp_path / "g" / "node0")
    node = cfgmod.load_node(d)
    assert node.ledger.current_number() == 0
    node.storage.close()
    gpath = os.path.join(d, "genesis")
    with open(gpath) as f:
        text = re.sub(r"node\.0=[0-9a-f]+", "node.0=" + "ab" * 64, f.read())
    with open(gpath, "w") as f:
        f.write(text)
    with pytest.raises(ValueError, match="genesis block"):
        cfgmod.load_node(d)


def test_load_node_puts_the_suite_on_the_config_device(tmp_path):
    """_load_node_parts passes the ini's device to make_suite: a node the
    ini puts on the CPU runs there; on the card by default, and with no
    card that refuses to build rather than running on the CPU."""
    import torch

    pbuild.build_chain(str(tmp_path / "d"), 1, consensus="solo", device="cpu")
    d = str(tmp_path / "d" / "node0")
    cfg, _, suite, _ = pconfig._load_node_parts(d)
    assert cfg.device == "cpu" and suite.device.type == "cpu" and suite.backend == "auto"
    pbuild.build_chain(str(tmp_path / "e"), 1, consensus="solo")
    e = str(tmp_path / "e" / "node0")
    if torch.cuda.is_available():
        assert pconfig._load_node_parts(e)[2].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pconfig._load_node_parts(e)


def test_build_chain_runs_as_a_module_and_max_mode_waits(tmp_path, capsys):
    out = str(tmp_path / "m")
    pbuild.main(["-n", "2", "-o", out, "--sm", "--sm-tls", "--p2p-base-port", "30400",
                 "--rpc-base-port", "20400", "--device", "cpu"])
    info = json.loads(capsys.readouterr().out)
    assert info["sm_crypto"] and info["sm_tls"]
    assert [n["p2p_port"] for n in info["nodes"]] == [30400, 30401]
    cfg = pconfig.node_config_from_ini(open(os.path.join(out, "node1", "config.ini")).read())
    assert (cfg.sm_crypto, cfg.device, cfg.rpc_port, cfg.p2p_peers) == \
        (True, "cpu", 20401, [("127.0.0.1", 30400)])
    assert os.path.exists(os.path.join(out, "node1", "node.smtls"))
    with pytest.raises(NotImplementedError, match="A3.14"):
        pbuild.main(["-n", "1", "-o", str(tmp_path / "x"), "--mode", "max"])
    assert not os.path.exists(tmp_path / "x")
    with pytest.raises(NotImplementedError, match="A3.14"):
        pconfig.load_max_node(os.path.join(out, "node0"), "max_cluster.json", "m0")


def test_the_monitor_bundle_is_the_jax_builds(tmp_path):
    pbuild.build_chain(str(tmp_path / "p"), 2, crypto_backend="host", metrics_base_port=0,
                       device="cpu")
    jbuild.build_chain(str(tmp_path / "j"), 2, crypto_backend="host", metrics_base_port=0)
    for name in ("prometheus.yml", "Dashboard.json"):
        assert (tmp_path / "p" / "monitor" / name).read_bytes() == \
            (tmp_path / "j" / "monitor" / name).read_bytes()
