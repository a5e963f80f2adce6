"""The port's node daemon (init/daemon.py, `python -m fisco_bcos_tpu_torch`)
as OS processes on this machine's CPU: a node directory from the port's
build_chain (device cpu, crypto_backend host) boots, takes a tx over
JSON-RPC and commits it; SIGTERM ends it with exit code 0 and removes its
node.pid; a restart reopens at the same height; a second daemon on a live
directory exits 3; SIGHUP reopens the log file; a config on the card
with no card exits non-zero; a [groups] daemon routes by the group param;
and a 4-process chain of two port and two JAX-package daemons (the JAX
ones with JAX_PLATFORMS=cpu) over loopback TCP commits height 1 with
equal header hashes.

Every child has a deadline and is killed in `finally`. Ports are bound on
port 0, read and released; a boot that finds its port taken is retried
on fresh ports.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from fisco_bcos_tpu_torch.crypto.suite import make_suite
from fisco_bcos_tpu_torch.executor import precompiled as pc
from fisco_bcos_tpu_torch.protocol import Transaction
from fisco_bcos_tpu_torch.rpc.server import JSONRPC_GROUP_NOT_FOUND
from fisco_bcos_tpu_torch.tool.build_chain import build_chain
from fisco_bcos_tpu_torch.tool.config import node_config_from_ini, node_config_to_ini

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOT_S = 90.0      # a child's deadline to answer over RPC
STOP_S = 30.0      # a child's deadline to exit after SIGTERM
MODULES = {"port": "fisco_bcos_tpu_torch", "jax": "fisco_bcos_tpu"}


def free_ports(n: int) -> list:
    """n ports the kernel gave to sockets bound on port 0, released."""
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    try:
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def rpc(port: int, method: str, params: list, timeout: float = 10.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", headers={"Content-Type": "application/json"},
        data=json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                         "params": params}).encode())
    with urllib.request.urlopen(req, timeout=timeout) as f:
        return json.load(f)


def chain(root, n: int, consensus: str = "pbft", **fields) -> list:
    """A build_chain directory of n nodes on fresh ports (p2p and RPC),
    device cpu, crypto_backend host, `fields` set in every config.ini.
    -> [(node dir, rpc port)]."""
    ports = free_ports(2 * n)
    build_chain(str(root), n, consensus=consensus, crypto_backend="host", device="cpu",
                p2p_ports=ports[:n])
    out = []
    for i in range(n):
        d = os.path.join(str(root), f"node{i}")
        path = os.path.join(d, "config.ini")
        with open(path) as f:
            cfg = node_config_from_ini(f.read())
        cfg.rpc_port, cfg.profile_hz = ports[n + i], 0
        for k, v in fields.items():
            setattr(cfg, k, v)
        with open(path, "w") as f:
            f.write(node_config_to_ini(cfg))
        out.append((d, ports[n + i]))
    return out


class Daemons:
    """Child daemon processes, each killed in close() if still running."""

    def __init__(self):
        self.procs = []

    def start(self, node_dir: str, pkg: str = "port", log: str = "daemon.log"):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
        with open(os.path.join(node_dir, f"{pkg}.out"), "ab") as out:
            p = subprocess.Popen([sys.executable, "-m", MODULES[pkg], node_dir,
                                  "--log-file", os.path.join(node_dir, log)],
                                 stdout=out, stderr=subprocess.STDOUT, env=env, cwd=REPO)
        p.node_dir = node_dir
        self.procs.append(p)
        return p

    @staticmethod
    def log(p) -> str:
        text = ""
        for name in os.listdir(p.node_dir):
            if name.endswith((".log", ".out")):
                with open(os.path.join(p.node_dir, name), errors="replace") as f:
                    text += f"--- {name}\n" + f.read()[-2000:]
        return text

    def up(self, p, port: int, group: str = "group0") -> None:
        """Wait until daemon p answers getBlockNumber on port."""
        deadline = time.monotonic() + BOOT_S
        while time.monotonic() < deadline:
            if p.poll() is not None:
                if "Address already in use" in self.log(p):
                    raise PortTaken()
                raise AssertionError(f"daemon exited {p.returncode}:\n{self.log(p)}")
            try:
                if "result" in rpc(port, "getBlockNumber", [group, ""], timeout=2):
                    return
            except OSError:
                pass
            time.sleep(0.1)
        raise AssertionError(f"daemon did not answer in {BOOT_S} s:\n{self.log(p)}")

    @staticmethod
    def stop(p) -> int:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
        return p.wait(timeout=STOP_S)

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=STOP_S)
            except subprocess.TimeoutExpired:
                pass


class PortTaken(Exception):
    """A daemon's port was taken between its release and the boot."""


def booted(tmp_path, n: int, pkgs=None, **kw):
    """Build a chain and boot every node (pkgs[i]'s package), on fresh
    ports until none is taken (3 tries). -> (Daemons, [(dir, rpc port)],
    [Popen])."""
    for attempt in range(3):
        ds = Daemons()
        nodes = chain(tmp_path / f"chain{attempt}", n, **kw)
        try:
            procs = [ds.start(d, (pkgs or ["port"] * n)[i]) for i, (d, _) in enumerate(nodes)]
            for p, (_, port) in zip(procs, nodes):
                ds.up(p, port)
            return ds, nodes, procs
        except PortTaken:
            ds.close()
    raise AssertionError("three boots found a port taken")


def register_frame(name: bytes, nonce: str) -> bytes:
    s = make_suite(backend="host")
    return Transaction(to=pc.BALANCE_ADDRESS, nonce=nonce, block_limit=500,
                       input=pc.encode_call("register", lambda w: w.blob(name).u64(9))
                       ).sign(s, s.generate_keypair(b"daemon-user")).encode()


def send(port: int, frame: bytes, group: str = "group0") -> dict:
    return rpc(port, "sendTransaction", [group, "", "0x" + frame.hex(), False, True])


def wait_height(port: int, height: int, group: str = "group0", timeout: float = 60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if rpc(port, "getBlockNumber", [group, ""])["result"] >= height:
            return
        time.sleep(0.05)
    raise AssertionError(f"height {height} not reached on port {port}")


def test_a_daemon_commits_stops_restarts_and_refuses_a_double_start(tmp_path):
    ds, [(d, port)], [p] = booted(tmp_path, 1, consensus="solo")
    try:
        pid_file = os.path.join(d, "node.pid")
        assert open(pid_file).read().strip() == str(p.pid)
        rep = send(port, register_frame(b"a", "d1"))["result"]
        assert rep["status"] == 0
        wait_height(port, 1)
        # a second daemon on the live directory: exit code 3, the pid file kept
        assert ds.start(d, log="double.log").wait(timeout=BOOT_S) == 3
        assert open(pid_file).read().strip() == str(p.pid)
        assert "boot-refused" in open(os.path.join(d, "double.log")).read()
        assert ds.stop(p) == 0 and not os.path.exists(pid_file)
        assert "[DAEMON][down]" in open(os.path.join(d, "daemon.log")).read()
        # a restart replays the WAL: the same height and block
        q = ds.start(d)
        ds.up(q, port)
        assert rpc(port, "getBlockNumber", ["group0", ""])["result"] == 1
        got = rpc(port, "getTransactionReceipt", ["group0", "", rep["transactionHash"]])
        assert got["result"]["status"] == 0
        assert ds.stop(q) == 0 and not os.path.exists(pid_file)
    finally:
        ds.close()


def test_sighup_reopens_the_log_file(tmp_path):
    ds, [(d, port)], [p] = booted(tmp_path, 1, consensus="solo")
    try:
        log = os.path.join(d, "daemon.log")
        os.rename(log, log + ".1")   # as logrotate moves it
        p.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 30
        while not os.path.exists(log) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert os.path.exists(log) and "log-reopened" in open(log).read()
        assert send(port, register_frame(b"h", "h1"))["result"]["status"] == 0
        assert ds.stop(p) == 0
        assert "[DAEMON][down]" in open(log).read()
        assert "[DAEMON][down]" not in open(log + ".1").read()
    finally:
        ds.close()


def test_a_daemon_on_the_card_without_a_card_exits_non_zero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the daemon would run there")
    [(d, port)] = chain(tmp_path / "c", 1, consensus="solo", device="cuda",
                        crypto_backend="auto")
    ds = Daemons()
    try:
        rc = ds.start(d).wait(timeout=BOOT_S)
        assert rc == 1, Daemons.log(ds.procs[0])
        log = open(os.path.join(d, "daemon.log")).read()
        assert "boot-failed" in log and "no CUDA device" in log
        assert not os.path.exists(os.path.join(d, "node.pid"))
    finally:
        ds.close()


def test_a_groups_daemon_routes_by_group(tmp_path):
    ds, [(d, port)], [p] = booted(tmp_path, 1, consensus="solo", groups=["group0", "group1"])
    try:
        assert rpc(port, "getGroupList", [])["result"]["groupList"] == ["group0", "group1"]
        s = make_suite(backend="host")
        tx = Transaction(to=pc.BALANCE_ADDRESS, nonce="g1", block_limit=500, group_id="group1",
                         input=pc.encode_call("register", lambda w: w.blob(b"g").u64(9))
                         ).sign(s, s.generate_keypair(b"group-user")).encode()
        assert send(port, tx, "group1")["result"]["status"] == 0
        wait_height(port, 1, "group1")
        assert rpc(port, "getBlockNumber", ["group0", ""])["result"] == 0
        assert rpc(port, "getBlockNumber", ["group1", ""])["result"] == 1
        err = rpc(port, "getBlockNumber", ["group9", ""])["error"]
        assert err["code"] == JSONRPC_GROUP_NOT_FOUND and "group9" in err["message"]
        assert "up-multigroup" in open(os.path.join(d, "daemon.log")).read()
        assert ds.stop(p) == 0
    finally:
        ds.close()


def test_two_port_and_two_jax_daemons_commit_one_chain(tmp_path):
    """A 4-node PBFT chain of processes over loopback TCP: nodes 0-1 the
    port's daemon, nodes 2-3 the JAX package's, on one build_chain
    directory (the JAX reader ignores the port's device key)."""
    ds, nodes, procs = booted(tmp_path, 4, pkgs=["port", "port", "jax", "jax"],
                              view_timeout=10.0, min_seal_time=0.2)
    try:
        ports = [port for _, port in nodes]
        deadline = time.monotonic() + 60
        while any(len(rpc(q, "getPeers", [])["result"]["peers"]) < 3 for q in ports):
            assert time.monotonic() < deadline, "the mesh did not come up"
            time.sleep(0.1)
        rep = send(ports[0], register_frame(b"mixed", "m1"))
        assert "result" in rep, rep
        for q in ports:
            wait_height(q, 1)
        hashes = {rpc(q, "getBlockHashByNumber", ["group0", "", 1])["result"] for q in ports}
        assert len(hashes) == 1
        heads = [rpc(q, "getBlockByNumber", ["group0", "", 1, True, False])["result"]
                 for q in ports]
        assert len({(h["stateRoot"], h["txsRoot"], h["receiptsRoot"]) for h in heads}) == 1
        assert [ds.stop(p) for p in procs] == [0, 0, 0, 0]
        assert not any(os.path.exists(os.path.join(d, "node.pid")) for d, _ in nodes)
    finally:
        ds.close()


def worker_daemon(tmp_path, pkg: str):
    """A solo daemon of the package with [scheduler] workers = 2 commits a
    register in its pool, then stops on SIGTERM. -> (getSystemStatus'
    execWorkers, the worker pids, the exit code)."""
    ds, [(d, port)], [p] = booted(tmp_path / pkg, 1, pkgs=[pkg], consensus="solo",
                                  scheduler_workers=2)
    try:
        assert "workers = 2" in open(os.path.join(d, "config.ini")).read()
        assert send(port, register_frame(b"w", "w1"))["result"]["status"] == 0
        wait_height(port, 1)
        status = rpc(port, "getSystemStatus", ["group0"])["result"]["execWorkers"]
        pids = [w["pid"] for w in status["per_worker"]]
        rc = ds.stop(p)
        assert not os.path.exists(os.path.join(d, "node.pid"))
        deadline = time.monotonic() + STOP_S
        while any(os.path.exists(f"/proc/{q}") for q in pids) and time.monotonic() < deadline:
            time.sleep(0.1)
        gone = not any(os.path.exists(f"/proc/{q}") for q in pids)
        return status, gone, rc
    finally:
        ds.close()


def test_a_daemon_with_scheduler_workers_runs_its_pool_as_the_jax_daemon(tmp_path):
    """A node directory with [scheduler] workers = 2 boots under `python -m
    fisco_bcos_tpu_torch`, executes its block in the pool, reports the
    pool in getSystemStatus as the JAX daemon does, and stops cleanly:
    exit code 0, its workers gone with it."""
    got, gone, rc = worker_daemon(tmp_path, "port")
    want, jgone, jrc = worker_daemon(tmp_path, "jax")
    assert (rc, gone) == (jrc, jgone) == (0, True)
    assert sorted(got) == sorted(want) and got["workers"] == want["workers"] == 2
    assert [sorted(w) for w in got["per_worker"]] == [sorted(w) for w in want["per_worker"]]
    assert got["fallbacks"] == 0 and sum(w["blocks"] for w in got["per_worker"]) >= 1
    assert all(w["alive"] for w in got["per_worker"])
