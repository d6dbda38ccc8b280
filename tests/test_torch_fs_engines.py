"""The port's file-system tier against the JAX package's, scenario by
scenario.

The scenarios of ``tests/test_engine_registry.py``,
``test_core_engines.py``, ``test_core_structures.py`` (``RadixTree``,
``LRUList``; the property tests as seeded random runs, no hypothesis)
and ``test_core_wal.py``, written once and run on both packages
(``pkg``). Each scenario keeps its own assertions and records what it
observes: ``fs.stats()`` and ``fs.simulated_time`` at its checkpoints, and
the bytes ``pread`` returns (after ``crash()``/``recover()`` too). The
port's case also holds that record equal (``==``, floats included) to
the reference's on the same seed and operations.
"""
import importlib
import random
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path
from types import SimpleNamespace

import pytest

PKGS = ("repro", "repro_torch")
ALL_ENGINES = ("nvpages", "nvlog", "psync", "psync_fsync", "nvhybrid")
SRC = Path(__file__).resolve().parents[1] / "src"


def _ns(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    core, engines, base = mod("core"), mod("core.engines"), \
        mod("core.engines.base")
    wal = mod("core.wal")
    return SimpleNamespace(
        pkg=pkg, NVCacheFS=core.NVCacheFS, PAGE_SIZE=core.PAGE_SIZE,
        ENGINES=core.ENGINES, EngineSpec=engines.EngineSpec,
        CacheEngine=engines.CacheEngine, get_engine=engines.get_engine,
        list_engines=engines.list_engines,
        register_engine=engines.register_engine, registry=base._REGISTRY,
        RadixTree=mod("core.radix").RadixTree, LRUList=mod("core.lru").LRUList,
        CircularWAL=wal.CircularWAL, HEADER_SIZE=wal.HEADER_SIZE,
        main=mod("core.engines.__main__").main)


class Probe:
    """What a scenario observed, in order."""

    def __init__(self):
        self.seen = []

    def fs(self, fs):
        self.seen.append(("stats", fs.stats(), fs.simulated_time))

    def data(self, blob):
        self.seen.append(("bytes", blob))
        return blob

    def value(self, v):
        self.seen.append(("value", v))
        return v


_SEEN: dict = {}


def _run(scenario, pkg, kw):
    key = (scenario.__name__, tuple(sorted(kw.items())), pkg)
    if key not in _SEEN:
        probe = Probe()
        scenario(_ns(pkg), probe, **kw)
        _SEEN[key] = probe.seen
    return _SEEN[key]


def check(scenario, pkg, **kw):
    """Run ``scenario`` on ``pkg``; on the port, also hold its record to
    the reference's."""
    seen = _run(scenario, pkg, kw)
    assert seen, "the scenario recorded nothing"
    if pkg == "repro_torch":
        want = _run(scenario, "repro", kw)
        assert len(seen) == len(want)
        for i, (got, ref) in enumerate(zip(seen, want)):
            assert got == ref, f"observation {i} differs from the reference"


def spec(ns, engine, **kw):
    return ns.EngineSpec(engine=engine, **kw)


# ================================================================ registry
def _engines_derived_from_registry(ns, probe):
    assert ns.ENGINES == ns.list_engines()
    assert set(ALL_ENGINES) == set(ns.ENGINES)
    for name in ns.ENGINES:
        assert issubclass(ns.get_engine(name), ns.CacheEngine)
        assert ns.get_engine(name).engine_name == name
        probe.value((name, ns.get_engine(name).__name__,
                     ns.get_engine(name).uses_nvmm))


def _unknown_engine_raises_value_error(ns, probe):
    with pytest.raises(ValueError, match="unknown cache engine"):
        ns.NVCacheFS("nvtapes")
    with pytest.raises(ValueError, match="nvtapes"):
        ns.get_engine("nvtapes")
    probe.value(ns.list_engines())


def _register_engine_round_trip(ns, probe):
    @ns.register_engine("_test_engine")
    class _TestEngine(ns.get_engine("psync")):
        pass
    try:
        assert "_test_engine" in ns.list_engines()
        fs = ns.NVCacheFS("_test_engine")
        fd = fs.open("/f")
        fs.pwrite(fd, b"x" * 100, 5)
        assert probe.data(fs.pread(fd, 100, 5)) == b"x" * 100
        probe.fs(fs)
        # the --list CLI must survive a docstring-less plugin class
        assert ns.main(["--list"]) == 0
        with pytest.raises(ValueError, match="already registered"):
            ns.register_engine("_test_engine")(_TestEngine)
        ns.register_engine("_test_engine", override=True)(_TestEngine)
    finally:
        ns.registry.pop("_test_engine", None)
    assert "_test_engine" not in ns.list_engines()


def _facade_constructs_from_spec(ns, probe):
    sp = spec(ns, "nvpages", nvmm_bytes=1 << 20, shards=2)
    fs = ns.NVCacheFS(sp)
    assert fs.engine == "nvpages" and fs.spec is sp
    assert fs.cache.num_shards == 2
    assert fs.cache.nvmm_capacity_bytes() == 1 << 20
    probe.fs(fs)
    with pytest.raises(TypeError, match="inside the EngineSpec"):
        ns.NVCacheFS(sp, nvmm_bytes=2 << 20)
    with pytest.raises(TypeError, match="shards"):
        ns.NVCacheFS(sp, shards=1)


def _runtime_registered_engine_visible(ns, probe):
    """``list_engines()`` is live; ``ENGINES`` is an import-time
    snapshot."""
    @ns.register_engine("_plug")
    class _Plug(ns.get_engine("nvlog")):
        pass
    try:
        assert "_plug" in ns.list_engines()
        assert "_plug" not in ns.ENGINES
        probe.value(ns.list_engines())
    finally:
        ns.registry.pop("_plug", None)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", [
    _engines_derived_from_registry, _unknown_engine_raises_value_error,
    _register_engine_round_trip, _facade_constructs_from_spec,
    _runtime_registered_engine_visible], ids=lambda f: f.__name__[1:])
def test_registry(pkg, scenario):
    check(scenario, pkg)


FS_FIELDS = ("nvmm_bytes", "dram_cache_bytes", "shards", "drain_batch",
             "o_direct", "lpc_capacity_pages", "hybrid_threshold",
             "hybrid_log_fraction", "drain_shards")


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_spec_defaults(pkg):
    """The reference's defaults, but for ``engine``: the port's spec
    defaults to its KV engine ``paged`` (a deliberate difference)."""
    ns = _ns(pkg)
    sp = ns.EngineSpec()
    assert sp.engine == {"repro": "nvlog", "repro_torch": "paged"}[pkg]
    assert sp.nvmm_bytes == 2 << 30
    assert sp.dram_cache_bytes == 2 << 30
    assert sp.shards == 1
    assert sp.drain_batch == 64
    assert sp.o_direct is False
    assert sp.lpc_capacity_pages is None
    assert 0 < sp.hybrid_threshold <= ns.PAGE_SIZE
    assert 0.0 < sp.hybrid_log_fraction < 1.0


def test_port_spec_default_is_the_kv_engine_and_fs_refuses_it():
    from repro.core.engines import EngineSpec as JaxSpec
    from repro_torch.core import NVCacheFS, EngineSpec
    from repro_torch.core.engines import get_engine, get_kv_engine
    assert EngineSpec().engine == "paged"
    for f in FS_FIELDS + ("kv_hbm_bytes", "kv_hot_window",
                          "prefix_cache_tokens", "async_tiering",
                          "transfer_max_retries", "transfer_backoff_s"):
        assert getattr(EngineSpec(), f) == getattr(JaxSpec(), f), f
    # each registry refuses the other's names, naming both registries
    for name in ("paged", "log", "kvhybrid"):
        with pytest.raises(ValueError, match=f"unknown cache engine "
                           f"'{name}'.*KV engine registry"):
            get_engine(name)
    for name in ("nvpages", "nvlog", "nvhybrid", "psync"):
        with pytest.raises(ValueError, match=f"unknown KV engine "
                           f"'{name}'.*file-system engine registry"):
            get_kv_engine(name)
    # the reference builds nvlog from a bare spec; the port's names paged
    with pytest.raises(ValueError, match="'paged' is in the KV engine"):
        NVCacheFS(EngineSpec(nvmm_bytes=1 << 20))
    assert NVCacheFS(nvmm_bytes=1 << 20).engine == "nvlog"


@pytest.mark.parametrize("pkg", PKGS)
def test_engines_list_entry_point(pkg):
    proc = subprocess.run(
        [sys.executable, "-m", f"{pkg}.core.engines", "--list"],
        capture_output=True, text=True, env={"PYTHONPATH": str(SRC)},
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name in ALL_ENGINES + ("paged", "log", "kvhybrid"):
        assert name in proc.stdout


# ============================================================= conformance
def _conformance(ns, probe, engine):
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS(spec(ns, engine, nvmm_bytes=1 << 20,
                           dram_cache_bytes=1 << 18))
    fd = fs.open("/f")
    fs.pwrite(fd, b"\xAA" * P, 0)
    fs.pwrite(fd, b"tiny", P + 17)
    assert probe.data(fs.pread(fd, P, 0)) == b"\xAA" * P
    assert probe.data(fs.pread(fd, 4, P + 17)) == b"tiny"
    fs.fsync(fd)
    fs.pwrite(fd, b"\xBB" * 64, 2 * P)
    probe.fs(fs)
    fs.crash()
    probe.value(fs.recover())
    fd = fs.open("/f")
    assert probe.data(fs.pread(fd, P, 0)) == b"\xAA" * P
    assert probe.data(fs.pread(fd, 4, P + 17)) == b"tiny"
    durable_at_return = fs.cache.uses_nvmm or engine == "psync_fsync"
    want = b"\xBB" * 64 if durable_at_return else b"\x00" * 64
    assert probe.data(fs.pread(fd, 64, 2 * P)) == want
    probe.fs(fs)


def _vectorized_iov(ns, probe, engine):
    fs = ns.NVCacheFS(spec(ns, engine, nvmm_bytes=1 << 20,
                           dram_cache_bytes=1 << 18))
    fd = fs.open("/f")
    iov = [(1000 * i, bytes([i]) * (i + 1)) for i in range(20)]
    assert fs.pwritev(fd, iov) == sum(len(d) for _, d in iov)
    got = fs.preadv(fd, [(off, len(d)) for off, d in iov])
    assert got == [d for _, d in iov]
    probe.value(got)
    probe.fs(fs)


def _read_after_write(ns, probe, engine):
    fs = ns.NVCacheFS(engine, nvmm_bytes=1 << 20, dram_cache_bytes=1 << 18)
    fd = fs.open("/f")
    _rand_ops(fs, fd, 1500, 1 << 18, probe)
    probe.fs(fs)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("engine", ALL_ENGINES)
@pytest.mark.parametrize("scenario", [_conformance, _vectorized_iov,
                                      _read_after_write],
                         ids=lambda f: f.__name__[1:])
def test_engine_contract(pkg, engine, scenario):
    check(scenario, pkg, engine=engine)


def _rand_ops(fs, fd, n_ops, file_bytes, probe, seed=7, write_frac=0.5):
    """``test_core_engines``' random op stream (sub-page writes)."""
    rng = random.Random(seed)
    oracle = {}
    for _ in range(n_ops):
        off = rng.randrange(0, file_bytes - 64)
        if rng.random() < write_frac:
            data = bytes([rng.randrange(256)]) * rng.randrange(1, 64)
            fs.pwrite(fd, data, off)
            for j, b in enumerate(data):
                oracle[off + j] = b
        else:
            n = rng.randrange(1, 64)
            got = probe.data(fs.pread(fd, n, off))
            assert got == bytes(oracle.get(off + j, 0) for j in range(n))
    return oracle


def _mixed_ops(fs, fd, n_ops, file_bytes, seed, P, probe):
    """``test_engine_registry``' mixed sizes: tiny records, mid-size, and
    full aligned pages."""
    rng = random.Random(seed)
    oracle = {}
    for _ in range(n_ops):
        kind = rng.random()
        if kind < 0.4:
            off = rng.randrange(0, file_bytes - 64)
            data = bytes([rng.randrange(256)]) * rng.randrange(1, 64)
        elif kind < 0.6:
            off = rng.randrange(0, file_bytes - 3000)
            data = bytes([rng.randrange(256)]) * rng.randrange(1024, 3000)
        else:
            off = rng.randrange(0, file_bytes // P) * P
            data = bytes([rng.randrange(256)]) * P
        fs.pwrite(fd, data, off)
        for j, b in enumerate(data):
            oracle[off + j] = b
        if rng.random() < 0.3:
            off = rng.randrange(0, file_bytes - 256)
            got = probe.data(fs.pread(fd, 256, off))
            assert got == bytes(oracle.get(off + j, 0) for j in range(256))
    return oracle


def _image(ns, fs, fd, file_bytes, oracle, probe):
    """Read the whole file back page by page against the oracle."""
    P = ns.PAGE_SIZE
    img = b"".join(probe.data(fs.pread(fd, P, off))
                   for off in range(0, file_bytes, P))
    assert img == bytes(oracle.get(j, 0) for j in range(file_bytes))
    return img


# ================================================================ recovery
def _crash_recovery_no_data_loss(ns, probe, engine):
    fs = ns.NVCacheFS(engine, nvmm_bytes=1 << 20, dram_cache_bytes=1 << 17)
    fd = fs.open("/f")
    oracle = _rand_ops(fs, fd, 1200, 1 << 18, probe)
    probe.fs(fs)
    fs.crash()
    probe.value(fs.recover())
    _image(ns, fs, fs.open("/f"), 1 << 18, oracle, probe)
    probe.fs(fs)


def _recover_clean_image_remounts(ns, probe, engine):
    """Crash after a clean unload (flag 0) still rebuilds the volatile
    indices."""
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS(spec(ns, engine, nvmm_bytes=160 << 10,
                           dram_cache_bytes=1 << 16))
    fd = fs.open("/f")
    for off in range(0, 256 << 10, P):
        fs.pwrite(fd, bytes([off // P % 256]) * P, off)
    fs.unload()
    probe.fs(fs)
    fs.crash()
    probe.value(fs.recover())
    fd = fs.open("/f")
    for off in range(0, 256 << 10, P):
        fs.pwrite(fd, b"\x9A" * P, off)
    assert probe.data(fs.pread(fd, 4, 0)) == b"\x9A" * 4
    probe.fs(fs)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("engine", ["nvpages", "nvlog", "nvhybrid"])
@pytest.mark.parametrize("scenario", [_crash_recovery_no_data_loss,
                                      _recover_clean_image_remounts],
                         ids=lambda f: f.__name__[1:])
def test_persistent_engine_recovery(pkg, engine, scenario):
    check(scenario, pkg, engine=engine)


def _hybrid_matches_parents(ns, probe, seed):
    """nvhybrid recovers to exactly the state nvlog and nvpages recover
    to on the same mixed-size op stream (all equal the oracle)."""
    file_bytes = 1 << 18
    images = {}
    for engine in ("nvhybrid", "nvlog", "nvpages"):
        fs = ns.NVCacheFS(spec(ns, engine, nvmm_bytes=1 << 20,
                               dram_cache_bytes=1 << 17))
        fd = fs.open("/f")
        oracle = _mixed_ops(fs, fd, 400, file_bytes, seed, ns.PAGE_SIZE,
                            probe)
        probe.fs(fs)
        fs.crash()
        probe.value(fs.recover())
        images[engine] = _image(ns, fs, fs.open("/f"), file_bytes, oracle,
                                probe)
        probe.fs(fs)
    assert images["nvhybrid"] == images["nvlog"] == images["nvpages"]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_hybrid_crash_recover_matches_nvlog_and_nvpages(pkg, seed):
    check(_hybrid_matches_parents, pkg, seed=seed)


def _sharded_nvpages(ns, probe):
    """Paper §IV future work: independent redo logs per shard."""
    fs = ns.NVCacheFS("nvpages", nvmm_bytes=4 << 20, shards=4)
    fd = fs.open("/f")
    oracle = _rand_ops(fs, fd, 800, 1 << 19, probe, seed=3)
    fs.crash()
    probe.value(fs.recover())
    _image(ns, fs, fs.open("/f"), 1 << 19, oracle, probe)
    probe.fs(fs)


def _psync_loses_unsynced(ns, probe):
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS("psync")
    fd = fs.open("/f")
    fs.pwrite(fd, b"\xAA" * P, 0)
    fs.fsync(fd)
    fs.pwrite(fd, b"\xBB" * P, P)
    fs.crash()
    probe.value(fs.recover())
    fd = fs.open("/f")
    assert probe.data(fs.pread(fd, 4, 0)) == b"\xAA" * 4
    assert probe.data(fs.pread(fd, 4, P)) == b"\x00" * 4
    probe.fs(fs)


def _hybrid_page_takeover(ns, probe):
    """A large write to a journal-owned page drains the journal first."""
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS(spec(ns, "nvhybrid", nvmm_bytes=1 << 20,
                           dram_cache_bytes=1 << 17))
    fd = fs.open("/f")
    fs.pwrite(fd, b"abc", 10)
    fs.pwrite(fd, b"Z" * P, 0)
    assert fs.stats()["page_takeovers"] == 1
    fs.pwrite(fd, b"tail", P + 5)
    probe.fs(fs)
    fs.crash()
    probe.value(fs.recover())
    fd = fs.open("/f")
    assert probe.data(fs.pread(fd, P, 0)) == b"Z" * P
    assert probe.data(fs.pread(fd, 4, P + 5)) == b"tail"
    probe.fs(fs)


def _open_after_unload_rearms(ns, probe):
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS(spec(ns, "nvlog", nvmm_bytes=1 << 20,
                           dram_cache_bytes=1 << 17))
    fd = fs.open("/f")
    fs.pwrite(fd, b"one", 0)
    fs.unload()
    assert fs.nvmm_flag == 0
    fd = fs.open("/f")
    assert fs.nvmm_flag == 1
    fs.pwrite(fd, b"two", P)
    fs.crash()
    probe.value(fs.recover())
    fd = fs.open("/f")
    assert probe.data(fs.pread(fd, 3, 0)) == b"one"
    assert probe.data(fs.pread(fd, 3, P)) == b"two"
    probe.fs(fs)


def _stale_fd_write_rearms(ns, probe):
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS(spec(ns, "nvlog", nvmm_bytes=1 << 20,
                           dram_cache_bytes=1 << 17))
    fd = fs.open("/f")
    fs.unload()
    assert fs.nvmm_flag == 0
    fs.pwrite(fd, b"two", P)
    assert fs.nvmm_flag == 1
    fs.crash()
    probe.value(fs.recover())
    fd = fs.open("/f")
    assert probe.data(fs.pread(fd, 3, P)) == b"two"
    probe.fs(fs)


def _close_flushes_path(ns, probe):
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS("psync")
    fd = fs.open("/f")
    fs.pwrite(fd, b"\xAA" * P, 0)
    fs.close(fd)
    fs.crash()
    probe.value(fs.recover())
    fd = fs.open("/f")
    assert probe.data(fs.pread(fd, 4, 0)) == b"\xAA" * 4
    probe.fs(fs)


def _close_flush_scoped(ns, probe):
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS("psync")
    fa, fb = fs.open("/a"), fs.open("/b")
    fs.pwrite(fa, b"\xAA" * P, 0)
    fs.pwrite(fb, b"\xBB" * P, 0)
    fs.close(fa)
    fs.crash()
    probe.value(fs.recover())
    fa, fb = fs.open("/a"), fs.open("/b")
    assert probe.data(fs.pread(fa, 4, 0)) == b"\xAA" * 4
    assert probe.data(fs.pread(fb, 4, 0)) == b"\x00" * 4
    probe.fs(fs)


def _fsync_per_file(ns, probe):
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS("psync")
    fa, fb = fs.open("/a"), fs.open("/b")
    fs.pwrite(fa, b"\xAA" * P, 0)
    fs.pwrite(fb, b"\xBB" * P, 0)
    fs.fsync(fa)
    fs.crash()
    probe.value(fs.recover())
    fa, fb = fs.open("/a"), fs.open("/b")
    assert probe.data(fs.pread(fa, 4, 0)) == b"\xAA" * 4
    assert probe.data(fs.pread(fb, 4, 0)) == b"\x00" * 4
    probe.fs(fs)


def _close_keeps_other_fds(ns, probe):
    fs = ns.NVCacheFS("psync")
    fd1, fd2 = fs.open("/f"), fs.open("/f")
    fs.close(fd1)
    fs.pwrite(fd2, b"live", 0)
    assert probe.data(fs.pread(fd2, 4, 0)) == b"live"
    probe.fs(fs)


def _io_range_must_fit_file_span(ns, probe):
    fs = ns.NVCacheFS("psync")
    fa = fs.open("/a")
    fs.open("/b")
    end = (1 << 36) - 4
    with pytest.raises(AssertionError, match="file span"):
        fs.pwrite(fa, b"x" * 100, end)
    with pytest.raises(AssertionError, match="file span"):
        fs.pread(fa, 100, end)
    with pytest.raises(AssertionError, match="file span"):
        fs.pwritev(fa, [(end, b"x" * 100)])
    probe.fs(fs)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", [
    _sharded_nvpages, _psync_loses_unsynced, _hybrid_page_takeover,
    _open_after_unload_rearms, _stale_fd_write_rearms, _close_flushes_path,
    _close_flush_scoped, _fsync_per_file, _close_keeps_other_fds,
    _io_range_must_fit_file_span], ids=lambda f: f.__name__[1:])
def test_facade_lifecycle(pkg, scenario):
    check(scenario, pkg)


# ================================================= the paper's asymmetries
def _capacity_accounting(ns, probe):
    for engine in ("nvpages", "nvlog", "nvhybrid"):
        fs = ns.NVCacheFS(spec(ns, engine, nvmm_bytes=1 << 20,
                               dram_cache_bytes=1 << 18))
        fd = fs.open("/f")
        cap = fs.cache.nvmm_capacity_bytes()
        assert 0 < cap <= 1 << 20
        fs.pwrite(fd, b"\x77" * ns.PAGE_SIZE, 0)
        s = fs.stats()
        assert 0 <= s["nvmm_used_bytes"] <= cap == s["nvmm_capacity_bytes"]
        probe.fs(fs)


def _hybrid_never_overcommits(ns, probe):
    for nvmm in (128 << 10, 256 << 10, 1 << 20):
        fs = ns.NVCacheFS(spec(ns, "nvhybrid", nvmm_bytes=nvmm,
                               dram_cache_bytes=1 << 17))
        assert fs.cache.nvmm_capacity_bytes() == nvmm
        probe.fs(fs)


def _hybrid_routes_by_size(ns, probe):
    P = ns.PAGE_SIZE
    fs = ns.NVCacheFS(spec(ns, "nvhybrid", nvmm_bytes=2 << 20,
                           dram_cache_bytes=1 << 18))
    fd = fs.open("/f")
    for i in range(32):
        fs.pwrite(fd, b"s" * 32, 3 * P * i + 7)
    for i in range(32):
        fs.pwrite(fd, b"L" * P, (100 + i) * P)
    s = fs.stats()
    assert s["routed_log"] == 32
    assert s["routed_pages"] == 32
    assert s["log_log_appends"] == 32
    assert s["pages_nvmm_page_writes"] >= 32
    probe.fs(fs)


def _nvpages_used_bytes_tracks_occupancy(ns, probe):
    fs = ns.NVCacheFS(spec(ns, "nvpages", nvmm_bytes=160 << 10))
    fd = fs.open("/f")
    for off in range(0, 1 << 20, ns.PAGE_SIZE):
        fs.pwrite(fd, b"\x3C" * ns.PAGE_SIZE, off)
    cache = fs.cache
    assert cache.stats["evictions"] > 0
    occupied = sum(sh.max_frames - len(sh.free_frames)
                   for sh in cache.shards)
    assert cache.nvmm_used_bytes() >= occupied * ns.PAGE_SIZE
    assert cache.nvmm_used_bytes() <= cache.nvmm_capacity_bytes()
    assert sum(len(sh.pool) for sh in cache.shards) == occupied
    probe.fs(fs)


def _nvpages_double_write(ns, probe):
    """Paper §III: the redo log makes NVPages write data to NVMM twice."""
    fs = ns.NVCacheFS("nvpages", nvmm_bytes=8 << 20)
    fd = fs.open("/f")
    payload = 256 * 1024
    for off in range(0, payload, ns.PAGE_SIZE):
        fs.pwrite(fd, b"\x11" * ns.PAGE_SIZE, off)
    written = probe.value(fs.clock.bytes_moved("nvmm", "write"))
    assert 2 * payload <= written < 2.2 * payload
    probe.fs(fs)


def _nvlog_single_write(ns, probe):
    fs = ns.NVCacheFS("nvlog", nvmm_bytes=8 << 20)
    fd = fs.open("/f")
    payload = 256 * 1024
    for off in range(0, payload, ns.PAGE_SIZE):
        fs.pwrite(fd, b"\x22" * ns.PAGE_SIZE, off)
    written = probe.value(fs.clock.bytes_moved("nvmm", "write"))
    assert payload <= written < 1.1 * payload
    probe.fs(fs)


def _read_speed_asymmetry(ns, probe):
    """NVLog serves hot reads from DRAM, NVPages from NVMM."""
    results = {}
    for engine in ("nvlog", "nvpages"):
        fs = ns.NVCacheFS(engine, nvmm_bytes=32 << 20,
                          dram_cache_bytes=32 << 20)
        fd = fs.open("/f")
        for off in range(0, 1 << 20, ns.PAGE_SIZE):
            fs.pwrite(fd, b"\x33" * ns.PAGE_SIZE, off)
        t0 = fs.simulated_time
        for _ in range(3):
            for off in range(0, 1 << 20, ns.PAGE_SIZE):
                fs.pread(fd, ns.PAGE_SIZE, off)
        results[engine] = probe.value(fs.simulated_time - t0)
        probe.fs(fs)
    assert results["nvpages"] > 3 * results["nvlog"]


def _nvlog_stalls_when_log_full(ns, probe):
    fs = ns.NVCacheFS("nvlog", nvmm_bytes=64 << 10)
    fd = fs.open("/f")
    for off in range(0, 1 << 20, ns.PAGE_SIZE):
        fs.pwrite(fd, b"\x44" * ns.PAGE_SIZE, off)
    assert fs.cache.stats["stall_time"] > 0
    probe.fs(fs)


def _nvpages_eviction_bounded(ns, probe):
    fs = ns.NVCacheFS("nvpages", nvmm_bytes=1 << 20)
    fd = fs.open("/f")
    for off in range(0, 4 << 20, ns.PAGE_SIZE):
        fs.pwrite(fd, b"\x55" * ns.PAGE_SIZE, off)
    cache = fs.cache
    assert cache.stats["evictions"] > 0
    assert sum(len(sh.pool) for sh in cache.shards) <= sum(
        sh.max_frames for sh in cache.shards)
    probe.fs(fs)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", [
    _capacity_accounting, _hybrid_never_overcommits, _hybrid_routes_by_size,
    _nvpages_used_bytes_tracks_occupancy, _nvpages_double_write,
    _nvlog_single_write, _read_speed_asymmetry, _nvlog_stalls_when_log_full,
    _nvpages_eviction_bounded], ids=lambda f: f.__name__[1:])
def test_paper_asymmetries(pkg, scenario):
    check(scenario, pkg)


# ============================================================ structures
def _radix_basic(ns, probe):
    t = ns.RadixTree()
    t.insert(0, "a")
    t.insert(12345678, "b")
    t.insert(2 ** 32 - 1, "c")
    assert t.lookup(12345678) == "b"
    assert t.lookup(99) is None
    assert len(t) == 3
    t.delete(12345678)
    assert t.lookup(12345678) is None
    assert len(t) == 2
    assert probe.value(dict(t.items())) == {0: "a", 2 ** 32 - 1: "c"}
    with pytest.raises(KeyError, match="out of radix range"):
        t.insert(2 ** 32, "d")


def _radix_matches_dict(ns, probe, seed):
    rng = random.Random(seed)
    keys = [rng.randrange(0, 2 ** 20) for _ in range(rng.randrange(200))]
    t, d = ns.RadixTree(), {}
    for i, k in enumerate(keys):
        t.insert(k, i)
        d[k] = i
    assert len(t) == len(d)
    for k in keys:
        assert t.lookup(k) == d[k]
    assert probe.value(list(t.items())) and dict(t.items()) == d


def _lru_order(ns, probe):
    lru = ns.LRUList()
    for k in "abc":
        lru.touch(k)
    lru.touch("a")
    assert [lru.pop_lru() for _ in range(4)] == ["b", "c", "a", None]
    probe.value("ok")


def _lru_matches_ordered_dict(ns, probe, seed):
    rng = random.Random(seed)
    lru, model = ns.LRUList(), OrderedDict()
    for _ in range(300):
        op, k = rng.choice("tpr"), rng.randrange(21)
        if op == "t":
            lru.touch(k)
            model.pop(k, None)
            model[k] = True
        elif op == "r":
            lru.remove(k)
            model.pop(k, None)
        else:
            want = next(iter(model)) if model else None
            if want is not None:
                model.pop(want)
            assert probe.value(lru.pop_lru()) == want
    assert list(lru.lru_order()) == list(model.keys())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", [_radix_basic, _lru_order],
                         ids=lambda f: f.__name__[1:])
def test_structures(pkg, scenario):
    check(scenario, pkg)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scenario", [_radix_matches_dict,
                                      _lru_matches_ordered_dict],
                         ids=lambda f: f.__name__[1:])
def test_structures_against_models(pkg, seed, scenario):
    check(scenario, pkg, seed=seed)


# ==================================================================== WAL
def _records(recs):
    return [(r.seqno, r.offset, r.payload) for r in recs]


def _wal_roundtrip(ns, probe):
    wal = ns.CircularWAL(4096)
    recs = [(i * 100, bytes([i]) * 10) for i in range(5)]
    for off, payload in recs:
        wal.append(off, payload)
    got = [(r.offset, r.payload) for _, r in wal.iter_from(wal.tail)]
    assert probe.value(got) == recs


def _wal_full_raises(ns, probe):
    wal = ns.CircularWAL(128)
    wal.append(0, b"x" * (128 - ns.HEADER_SIZE))
    with pytest.raises(BufferError):
        wal.append(0, b"y")
    probe.value((wal.head, wal.used, wal.free))


def _wal_wraparound(ns, probe):
    wal = ns.CircularWAL(256)
    for i in range(50):
        wal.append(i, bytes([i % 256]) * 20)
        wal.reclaim_to(wal.head, wal.next_seqno)
    assert probe.value(_records(wal.recover_scan())) == []
    probe.value(bytes(wal.buf))


def _wal_recover_scan_unreclaimed(ns, probe):
    wal = ns.CircularWAL(4096)
    for i in range(4):
        wal.append(i * 10, b"a" * 8)
    recs = list(wal.iter_from(wal.tail))
    wal.reclaim_to(recs[2][0], recs[2][1].seqno)
    out = wal.recover_scan()
    assert [r.seqno for r in out] == [3, 4]
    probe.value(_records(out))


def _wal_torn_write(ns, probe):
    wal = ns.CircularWAL(4096)
    wal.append(0, b"good" * 4)
    start = wal.head
    wal.append(100, b"torn" * 4)
    wal.buf[(start + ns.HEADER_SIZE) % wal.capacity] ^= 0xFF
    out = wal.recover_scan()
    assert [r.offset for r in out] == [0]
    probe.value(_records(out))


def _wal_stale_lap(ns, probe):
    wal = ns.CircularWAL(128)
    wal.append(0, b"old!" * 4)
    wal.reclaim_to(wal.head, wal.next_seqno)
    assert probe.value(_records(wal.recover_scan())) == []


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", [
    _wal_roundtrip, _wal_full_raises, _wal_wraparound,
    _wal_recover_scan_unreclaimed, _wal_torn_write, _wal_stale_lap],
    ids=lambda f: f.__name__[1:])
def test_wal(pkg, scenario):
    check(scenario, pkg)
