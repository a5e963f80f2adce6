"""The port's persistent storage engines (storage/{wal,sstable,compact,
engine,keypage,namespace}.py and make_storage) against the JAX package's:
the same seeded changesets through both packages' WalStorage, DiskStorage,
KeyPageStorage, NamespacedStorage and make_storage, each in its own
temporary directory. Rows must be equal after every step (prepare,
commit, rollback, direct writes, memtable flushes, leveled compactions,
tombstones, prefix scans, close and reopen), and the files the two write
byte for byte (no file of these engines carries a clock or a random
field). A directory written by either package opens in the other with
identical rows; a torn WAL tail is truncated alike, and mid-stream
corruption refuses boot with the same error. The port's key pages differ
on purpose in their snapshot seams and batch writes (ROADMAP.md C):
capture_rows yields rows, not pages, and the pages it installs hold the
same rows.
"""

import importlib
import os
import random

import pytest

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
TABLES = ("t", "u", "s_num2hash")


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.storage.{name}")


def entry(root: str, value=None):
    I = mod(root, "interface")
    if value is None:
        return I.Entry(b"", I.EntryStatus.DELETED)
    return I.Entry(value)


def changesets(seed: int, n: int = 40, keys: int = 48):
    """n seeded changesets of (table, key) -> value or None (a delete),
    with values from 0 to 3 KB so the engines flush and split pages."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        cs = {}
        for _ in range(rng.randint(1, 12)):
            t = rng.choice(TABLES)
            k = b"k%03d" % rng.randrange(keys)
            cs[(t, k)] = None if rng.random() < 0.25 else rng.randbytes(rng.choice((0, 7, 90, 3000)))
        out.append(cs)
    return out


def to_cs(root: str, cs):
    return {k: entry(root, v) for k, v in cs.items()}


def rows(st, prefix: bytes = b""):
    return {t: {k: st.get(t, k) for k in st.keys(t, prefix)} for t in TABLES}


def files(path: str) -> dict:
    out = {}
    for d, _, fs in os.walk(path):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = fh.read()
    return out


def drive(root: str, st, seed: int, after=None):
    """The seeded stream: each changeset prepared and committed, every
    fifth rolled back instead, a direct set and remove between; `after`
    (the step index) runs after each step. -> rows after each step."""
    rng = random.Random(seed + 1)
    seen = []
    for i, cs in enumerate(changesets(seed)):
        st.prepare(i + 1, to_cs(root, cs))
        if i % 5 == 4:
            st.rollback(i + 1)
        else:
            st.commit(i + 1)
        st.set("u", b"direct%d" % (i % 7), rng.randbytes(20))
        if i % 3 == 0:
            st.remove("t", b"k%03d" % rng.randrange(48))
        if after is not None:
            after(i)
        seen.append((rows(st), rows(st, b"k01")))
    return seen


def open_engine(root: str, kind: str, path: str):
    if kind == "wal":
        return mod(root, "wal").WalStorage(path, compact_every=8)
    if kind == "disk":
        return mod(root, "engine").DiskStorage(path, memtable_bytes=4 << 10, max_segments=3,
                                               auto_compact=False, level_base_bytes=16 << 10,
                                               level_fanout=2)
    disk = mod(root, "engine").DiskStorage(path, memtable_bytes=4 << 10, auto_compact=False)
    return mod(root, "keypage").KeyPageStorage(disk, page_size=2048)


def engine_after(st, kind):
    """The disk engine's flush and compaction, run between steps."""
    disk = st.backend if kind == "keypage" else st

    def after(i):
        if kind == "wal":
            return
        if i % 4 == 3:
            disk.flush()
        if i % 9 == 8:
            disk.compact_once()
    return after


@pytest.mark.parametrize("kind", ["wal", "disk", "keypage"])
def test_engines_hold_equal_rows_and_write_equal_files(tmp_path, kind):
    out = {}
    for root in ROOTS:
        path = str(tmp_path / root)
        st = open_engine(root, kind, path)
        seen = drive(root, st, 14, engine_after(st, kind))
        st.close()
        reopened = open_engine(root, kind, path)
        out[root] = seen, rows(reopened), files(path)
        reopened.close()
    (jseen, jrows, jfiles), (pseen, prows, pfiles) = out.values()
    assert pseen == jseen
    assert prows == jrows == jseen[-1][0]
    assert any(jseen[-1][0].values())
    assert pfiles == jfiles


@pytest.mark.parametrize("kind", ["wal", "disk", "keypage"])
@pytest.mark.parametrize("writer", ROOTS)
def test_a_directory_opens_in_the_other_package(tmp_path, kind, writer):
    reader = ROOTS[1 - ROOTS.index(writer)]
    path = str(tmp_path / "db")
    st = open_engine(writer, kind, path)
    seen = drive(writer, st, 15, engine_after(st, kind))
    st.close()
    other = open_engine(reader, kind, path)
    try:
        assert rows(other) == seen[-1][0]
        # and it goes on writing there: the writer reads that back
        other.prepare(99, to_cs(reader, {("t", b"after"): b"x", ("u", b"direct1"): None}))
        other.commit(99)
        want = rows(other)
    finally:
        other.close()
    back = open_engine(writer, kind, path)
    try:
        assert rows(back) == want
    finally:
        back.close()


def test_disk_engine_flushes_compacts_and_drops_tombstones_alike(tmp_path):
    """Leveled compaction to the deepest level: the same levels,
    segments and debt, no tombstone left, and capture_rows streams the
    same rows."""
    stats = {}
    for root in ROOTS:
        st = open_engine(root, "disk", str(tmp_path / root))
        drive(root, st, 16, engine_after(st, "disk"))
        st.compact()
        s = st.stats()
        stats[root] = ({k: s[k] for k in ("segments", "levels", "compaction_debt_bytes")},
                       list(st.capture_rows()), rows(st))
        seg = st._flat_locked()
        assert all(v is not None for r in seg for _, _, v in r.iter_from())
        st.close()
    assert stats["fisco_bcos_tpu_torch"] == stats["fisco_bcos_tpu"]
    # every run in the deepest level, no debt left
    levels = stats["fisco_bcos_tpu"][0]["levels"]
    assert [lv["segments"] > 0 for lv in levels].count(True) == 1 and levels[-1]["segments"]
    assert stats["fisco_bcos_tpu"][0]["compaction_debt_bytes"] == 0


def test_disk_install_rows_swaps_the_state_alike(tmp_path):
    """install_rows replaces the carried tables and keeps the others."""
    got = {}
    for root in ROOTS:
        st = open_engine(root, "disk", str(tmp_path / root))
        drive(root, st, 17)
        st.install_rows({"t": {b"n%02d" % i: b"v%d" % i for i in range(30)}, "u": {}})
        got[root] = rows(st), list(st.capture_rows())
        st.close()
        again = open_engine(root, "disk", str(tmp_path / root))
        assert rows(again) == got[root][0]
        again.close()
    assert got["fisco_bcos_tpu_torch"] == got["fisco_bcos_tpu"]
    assert not got["fisco_bcos_tpu"][0]["u"] and got["fisco_bcos_tpu"][0]["s_num2hash"]


def test_key_page_snapshot_seams_speak_rows(tmp_path):
    """The port's KeyPageStorage.capture_rows yields the rows its pages
    hold, in (table, key) order, where the JAX package's yields the pages
    themselves; installing them re-pages the same rows. Over a
    WalStorage (no seams) neither appears, and export falls back to the
    row walk."""
    from fisco_bcos_tpu.storage import keypage as jkp
    from fisco_bcos_tpu_torch.storage import keypage as pkp

    j = open_engine("fisco_bcos_tpu", "keypage", str(tmp_path / "j"))
    p = open_engine("fisco_bcos_tpu_torch", "keypage", str(tmp_path / "p"))
    drive("fisco_bcos_tpu", j, 18, engine_after(j, "keypage"))
    drive("fisco_bcos_tpu_torch", p, 18, engine_after(p, "keypage"))
    want = rows(p)
    assert want == rows(j)
    flat = [(t, k, v) for t in sorted(want) for k, v in sorted(want[t].items())]
    assert list(p.capture_rows()) == flat
    pages = list(j.capture_rows())
    assert all(k == jkp.META_KEY or k.startswith(jkp.PAGE_PREFIX) for _, k, _ in pages)
    unpaged = [(t, k, v) for t, key, val in pages if key.startswith(jkp.PAGE_PREFIX)
               for k, v in sorted(jkp._unpack_page(val).items())]
    assert unpaged == flat
    p.install_rows({"t": {b"z%03d" % i: bytes(300) for i in range(40)}})
    assert rows(p)["t"] == {b"z%03d" % i: bytes(300) for i in range(40)}
    assert rows(p)["u"] == want["u"]
    assert all(len(v) <= 2048 for t, k, v in p.backend.capture_rows()
               if t == "t" and k.startswith(pkp.PAGE_PREFIX))
    j.close()
    p.close()
    wal = pkp.KeyPageStorage(mod("fisco_bcos_tpu_torch", "wal").WalStorage(str(tmp_path / "w")))
    assert not hasattr(wal, "capture_rows") and not hasattr(wal, "install_rows")
    wal.close()


def test_key_page_batches_write_each_page_once(tmp_path):
    """set_batch / remove_batch translate a batch once (one backend
    write a table, not one a row) and leave the same rows as the JAX
    package's row-at-a-time loops."""
    out = {}
    for root in ROOTS:
        st = open_engine(root, "keypage", str(tmp_path / root))
        writes = []
        for name in ("set_batch", "remove_batch", "set", "remove"):
            fn = getattr(st.backend, name)
            setattr(st.backend, name, lambda *a, _n=name, _f=fn: (writes.append(_n), _f(*a))[1])
        st.set_batch("t", [(b"b%04d" % i, bytes(40)) for i in range(400)])
        st.remove_batch("t", [b"b%04d" % i for i in range(0, 400, 3)])
        out[root] = rows(st), writes
        st.close()
    (jrows, jw), (prows, pw) = out.values()
    assert prows == jrows and len(prows["t"]) == 266
    assert len(jw) >= 534 and pw == ["set_batch", "set_batch"]   # 534 rows


def test_torn_tail_is_truncated_and_corruption_refuses_boot_alike(tmp_path):
    """A torn tail is truncated to the same files; a rotten record in the
    middle truncates WalStorage's one log there, and refuses the disk
    engine's boot (later segments hold durable records) with the same
    error."""
    from fisco_bcos_tpu.storage.wal import SegmentedWal

    for kind in ("wal", "disk"):
        sizes, errors = {}, {}
        for root in ROOTS:
            path = str(tmp_path / kind / root)
            st = open_engine(root, kind, path)
            drive(root, st, 19)
            want = rows(st)
            st.close()
            log = os.path.join(path, "wal.log") if kind == "wal" else \
                SegmentedWal.list_segments(path)[-1][1]
            with open(log, "ab") as f:
                f.write(b"\xde\xad\xbe\xef\x00\x01")
            again = open_engine(root, kind, path)
            assert rows(again) == want
            again.prepare(100, to_cs(root, {("t", b"post"): b"1"}))
            again.commit(100)
            if kind == "disk":
                # a later segment holds a durable record too (no close: a crash)
                again._wal.rotate()
                again.prepare(101, to_cs(root, {("t", b"late"): b"2"}))
                again.commit(101)
                segs = [p for _, p in SegmentedWal.list_segments(path) if os.path.getsize(p)]
            else:
                again.close()
                segs = [os.path.join(path, "wal.log")]
            sizes[root] = files(path)
            # rot a byte in the middle of the log, with records behind it
            with open(segs[0], "rb+") as f:
                f.seek(16)
                b = f.read(1)
                f.seek(16)
                f.write(bytes([b[0] ^ 0xFF]))
            if kind == "wal":
                # one log: what follows the rotten record is its torn tail
                again = open_engine(root, kind, path)
                errors[root] = rows(again)
                again.close()
                continue
            with pytest.raises(Exception) as exc:
                open_engine(root, kind, path).close()
            errors[root] = (type(exc.value).__name__, str(exc.value).replace(path, "<dir>"))
            again.close()
        assert sizes["fisco_bcos_tpu_torch"] == sizes["fisco_bcos_tpu"], kind
        assert errors["fisco_bcos_tpu_torch"] == errors["fisco_bcos_tpu"], kind
    assert errors["fisco_bcos_tpu"][0] == "WalCorruptionError", errors


def test_namespaced_storage_and_make_storage(tmp_path):
    """Two namespaces over one engine see only their rows; make_storage
    builds the same stack in both packages for every backend."""
    for root in ROOTS:
        base = open_engine(root, "wal", str(tmp_path / root / "ns"))
        N = mod(root, "namespace").NamespacedStorage
        a, b = N(base, "g1"), N(base, "g2")
        a.prepare(1, to_cs(root, {("t", b"x"): b"1", ("u", b"y"): b"2"}))
        a.commit(1)
        b.set("t", b"x", b"3")
        assert a.get("t", b"x") == b"1" and b.get("t", b"x") == b"3"
        assert list(b.keys("u")) == [] and list(a.keys("u")) == [b"y"]
        base.close()
    built = {}
    for root in ROOTS:
        make = importlib.import_module(f"{root}.storage").make_storage
        got = []
        for backend, page in (("auto", -1), ("memory", -1), ("wal", -1), ("wal", 1024),
                              ("disk", -1), ("disk", 0)):
            path = None if backend in ("auto", "memory") else \
                str(tmp_path / root / f"{backend}{page}")
            st = make(backend, path, key_page_size=page, memtable_mb=1)
            inner = getattr(st, "backend", None)
            got.append((type(st).__name__, type(inner).__name__ if inner else None,
                        getattr(st, "page_size", None)))
            if hasattr(st, "close"):
                st.close()
        with pytest.raises(ValueError):
            make("disk", None)
        with pytest.raises(ValueError):
            make("rocks", str(tmp_path / root / "x"))
        built[root] = got
    assert built["fisco_bcos_tpu_torch"] == built["fisco_bcos_tpu"]
    assert built["fisco_bcos_tpu"][4] == ("KeyPageStorage", "DiskStorage", 8 << 10)
