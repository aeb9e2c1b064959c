"""The sharded runtime with "t" across processes (``parallel/mesh.py``'s
"t" group, ``multihost.multihost_mesh(t_procs=...)``), on the CPU over
gloo: real worker processes, each stacking its own shards of "t".

One spawn of 2 processes (t_procs 2) runs every group collective on
seeded inputs, the sharded RX at GOLDEN64 t 4 and LTE1024 t 2 on
``tests/torch_parity.py:rx_buffer``'s frames (and on noise alone), the
sharded reacq stream (t 4) and the sharded legacy streams (CFO case 0 at
+1500 Hz, t 4; DSSS case 4, t 2).  One spawn of 4 processes (dp 2 x
t_procs 2) runs the dp x t chain on a small GOLDEN64 configuration with
injected noise.  Each rank's
results equal the other ranks' (they are replicated over the "t" group)
and this process's stacked run of the same mesh shape, exactly, and the
JAX package's sharded functions on its 8-device virtual CPU mesh
(tests/conftest.py): found, lock, delay, bits and detection tables exact,
peaks within 2e-3, phasors and channels within 2e-4.

The workers are this file's ``__main__`` and import no JAX, so
``tests/test_torch_cuda.py`` runs them on the card too:
    test_torch_cards.py <pid> <nproc> <coordinator> <dir> <device> <backend>
reads ``<dir>/jobs.pt`` and writes ``<dir>/out<pid>.pt``.
"""

import dataclasses
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
ATOL = 2e-4
PEAK_ATOL = 2e-3
FO_RANGE = (0.0, -1500.0, 1500.0)


# -- the worker ---------------------------------------------------------------

def _config(d):
    from lte_gnu_radio_code_tpu_torch.utils.params import OFDMConfig
    return OFDMConfig(**d).validate()


def _stack(outs):
    return {f: torch.stack([getattr(o, f) for o in outs])
            for f in outs[0]._fields}


def drive(rx, sig, chunk):
    """Every chunk of sig (the last zero-padded, with its real count), then
    finish(): each output field stacked over the chunk steps."""
    buf = sig.new_zeros(-(-len(sig) // chunk) * chunk)
    buf[:len(sig)] = sig
    outs = [rx.push(buf[i:i + chunk], n_real=max(0, min(chunk, len(sig) - i)))
            for i in range(0, len(buf), chunk)]
    return _stack(outs + rx.finish())


def _collectives(job, mesh):
    """Every collective of ``parallel/mesh.py`` on this process's part of
    the job's global shard axis."""
    from lte_gnu_radio_code_tpu_torch.parallel import mesh as pmesh

    out = {"axis_index": pmesh.axis_index(mesh.t_local, mesh.device, mesh)}
    for name, (x, dim) in job["inputs"].items():
        part = pmesh.local_part(mesh, x.to(mesh.device), dim)
        out[f"{name}.roll+1"] = pmesh.ppermute(part, 1, dim, mesh)
        out[f"{name}.roll-1"] = pmesh.ppermute(part, -1, dim, mesh)
        out[f"{name}.gather"] = pmesh.all_gather(part, dim, mesh)
        out[f"{name}.sum"] = pmesh.psum(part, dim, mesh)
        if not x.is_complex():
            out[f"{name}.min"] = pmesh.pmin(part, dim, mesh)
    try:
        pmesh.ppermute(part, 2, dim, mesh)
    except ValueError:
        out["shift 2 raises"] = torch.tensor(True)
    return out


def _rx(job, mesh):
    from lte_gnu_radio_code_tpu_torch.parallel import sharded

    x = job["x"].to(mesh.device)
    rx = sharded.make_sharded_rx(_config(job["cfg"]), x.shape[-1], mesh)
    return rx(x)._asdict()


def _stream(job, mesh):
    from lte_gnu_radio_code_tpu_torch.parallel import streaming

    cfg = _config(job["cfg"])
    if job["kind"] == "reacq":
        rx = streaming.ShardedReacqStreamingRx(cfg, job["chunk"], mesh)
    else:
        rx = streaming.ShardedLegacyStreamingRx(
            cfg, job["chunk"], mesh, fo_range=job["fo_range"],
            dsss=job["dsss"])
    x = job["x"].to(mesh.device)
    outs = drive(rx, x, job["chunk"])
    if job.get("no_sync"):
        # one more step, which must not wait for the host (not over gloo)
        torch.cuda.set_sync_debug_mode("error")
        try:
            rx.push(x[:job["chunk"]])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {**outs, **{f"state.{k}": v for k, v in rx.state._asdict().items()}}


def _chain(job, mesh):
    from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
    from lte_gnu_radio_code_tpu_torch.parallel import multihost

    ber, found, lock = pchain.make_sharded_chain(_config(job["cfg"]), mesh)(
        job["bits"], noise=job["noise"])
    g = multihost.gather_frames(mesh, ber, found, lock)
    return dict(ber=ber, found=found, lock=lock, all_ber=g[0],
                all_found=g[1], all_lock=g[2])


RUNNERS = {"collectives": _collectives, "rx": _rx, "reacq": _stream,
           "legacy": _stream, "chain": _chain}


def worker(pid, nproc, coord, out_dir, device, backend):
    """Runs ``<out_dir>/jobs.pt`` (name -> job, each with its "t" and
    "t_procs") on meshes from ``multihost_mesh`` and writes every output,
    on the CPU, with each job's kernel launch counts (K4's by route), to
    out<pid>.pt.  ``device`` "card": the card init_distributed picks."""
    import torch.distributed as dist
    from lte_gnu_radio_code_tpu_torch import kernels
    from lte_gnu_radio_code_tpu_torch.kernels import sync_search
    from lte_gnu_radio_code_tpu_torch.parallel import multihost

    out_dir = pathlib.Path(out_dir)
    jobs = torch.load(out_dir / "jobs.pt")
    if device == "cpu":
        # one thread: the processes share the host's cores, and the CPU
        # twins' products (K2's is a GEMM) round a row alike whatever the
        # row count, as in the stacked run (:func:`_stacked`)
        torch.set_num_threads(1)
    device = None if device == "card" else device
    assert multihost.init_distributed(coord, nproc, pid, backend=backend,
                                      device=device)
    results = {}
    for name, job in jobs.items():
        mesh = multihost.multihost_mesh(t=job["t"], device=device,
                                        t_procs=job["t_procs"])
        kernels.reset_launch_counts()
        got = RUNNERS[job["kind"]](job, mesh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        results[name] = {k: v.cpu() for k, v in got.items()}
        results[name]["launches"] = kernels.launch_counts()
        results[name]["routes"] = dict(sync_search.route_launches)
        results[name]["mesh"] = dict(mesh.shape, t_rank=mesh.t_rank,
                                     t_local=mesh.t_local)
    try:                                # 3 divides no world spawned here
        multihost.multihost_mesh(t=3 * nproc, device=device, t_procs=3)
    except ValueError:
        results["uneven world raises"] = True
    torch.save(results, out_dir / f"out{pid}.pt")
    dist.barrier()
    dist.destroy_process_group()
    print(f"CARDS_OK pid={pid} procs={nproc} jobs={len(jobs)}", flush=True)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(jobs, nproc, out_dir, device="cpu", backend="gloo"):
    """Runs the jobs in nproc worker processes of this file and returns
    each rank's results; fails on a worker that exits nonzero, lacks its
    OK line or outlasts the timeout."""
    out_dir = pathlib.Path(out_dir)
    torch.save(jobs, out_dir / "jobs.pt")
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(pid), str(nproc), coord, str(out_dir),
         device, backend], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(nproc)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"proc {pid} failed:\n{text[-4000:]}"
        assert f"CARDS_OK pid={pid} procs={nproc}" in text, text[-4000:]
    return [torch.load(out_dir / f"out{pid}.pt") for pid in range(nproc)]


def assert_replicated(ranks, name):
    """Every rank's outputs of job ``name`` equal rank 0's exactly: they
    are replicated over the "t" group."""
    for r in ranks[1:]:
        for k, v in ranks[0][name].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(r[name][k], v), (name, k)


def assert_equal_fields(got, ref, what):
    """Outputs of the t group against the stacked run's, exactly."""
    for k, v in ref.items():
        assert got[k].shape == v.shape, (what, k, got[k].shape, v.shape)
        assert torch.equal(got[k], v.cpu()), (what, k)


# -- the tests -----------------------------------------------------------------

def _streams_inputs():
    from torch_parity import port_cfg

    from lte_gnu_radio_code_tpu.reference_cpu import golden as G
    from lte_gnu_radio_code_tpu.utils import params as jparams

    cfg = jparams.GOLDEN64
    bits = np.random.default_rng(0).integers(0, 2, cfg.num_bits)
    reacq = G.apply_channel(G.tx_frame(cfg, bits), G.channel_taps("Fading"))
    out = {"reacq": (port_cfg(cfg), reacq.astype(np.complex64))}
    for table, case in (("CFO_CASES", 0), ("DSSS_CASES", 4)):
        c = jparams.config_from_case(getattr(jparams, table), case,
                                     snr_db=1e8)
        rng = np.random.default_rng(case)
        sig = np.concatenate([G.apply_channel(
            G.tx_frame(c, rng.integers(0, 2, c.num_bits)),
            G.channel_taps("Fading"), max_impulse=c.nfft) for _ in range(2)])
        if table == "CFO_CASES":
            sig = sig * np.exp(2j * np.pi * 1500.0 / c.fs *
                               np.arange(len(sig)))
        sig = sig + 1e-3 * (rng.standard_normal(len(sig)) +
                            1j * rng.standard_normal(len(sig)))
        out[table] = (port_cfg(c), sig.astype(np.complex64),
                      getattr(jparams, table)[case]["dsss"])
    return out


@pytest.fixture(scope="module")
def two_procs(tmp_path_factory):
    """The 2-process spawn: (its jobs, each rank's results)."""
    from torch_parity import port_cfg, rx_buffer

    from lte_gnu_radio_code_tpu.utils import params as jparams

    rng = np.random.default_rng(7)
    inputs = {
        "float": (torch.from_numpy(rng.standard_normal((4, 6)).astype(
            np.float32)), 0),
        "complex": (torch.from_numpy((rng.standard_normal((2, 4, 5)) +
                                      1j * rng.standard_normal((2, 4, 5)))
                                     .astype(np.complex64)), 1),
        "int": (torch.from_numpy(rng.integers(-50, 50, (3, 4, 2))), 1),
    }
    jobs = {"collectives": dict(kind="collectives", t=4, t_procs=2,
                                inputs=inputs)}
    for cfg, t in ((jparams.GOLDEN64, 4), (jparams.LTE1024, 2)):
        rx, _ = rx_buffer(cfg, seed=3)
        jobs[f"rx {cfg.nfft} t{t}"] = dict(
            kind="rx", t=t, t_procs=2,
            cfg=dataclasses.asdict(port_cfg(cfg)), x=torch.from_numpy(rx))
    n = len(jobs["rx 64 t4"]["x"])
    jobs["rx 64 t4 noise"] = dict(jobs["rx 64 t4"], x=torch.from_numpy(
        (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
        .astype(np.complex64)))
    streams = _streams_inputs()
    pcfg, sig = streams["reacq"]
    jobs["reacq t4"] = dict(kind="reacq", t=4, t_procs=2, chunk=1920,
                            cfg=dataclasses.asdict(pcfg),
                            x=torch.from_numpy(sig))
    for table, t, fo_range in (("CFO_CASES", 4, FO_RANGE),
                               ("DSSS_CASES", 2, (0.0,))):
        pcfg, sig, dsss = streams[table]
        jobs[f"legacy {table} t{t}"] = dict(
            kind="legacy", t=t, t_procs=2, chunk=t * pcfg.stride * 24,
            cfg=dataclasses.asdict(pcfg), x=torch.from_numpy(sig),
            fo_range=fo_range, dsss=dsss)
    return jobs, spawn(jobs, 2, tmp_path_factory.mktemp("two_procs"))


def _stacked(job):
    """The same job on a stacked mesh of the same shape in this process,
    on one thread, as each worker runs."""
    from lte_gnu_radio_code_tpu_torch.parallel import mesh as pmesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return RUNNERS[job["kind"]](job, pmesh.time_mesh(job["t"],
                                                         device="cpu"))
    finally:
        torch.set_num_threads(threads)


def test_group_collectives_equal_the_stacked_ops(two_procs):
    """Over 2 processes x t_local 2, each collective equals the stacked op
    over the 4 shards: axis_index and ppermute +-1 give each process its
    part, pmin and all_gather the whole (in global shard order), psum the
    sum of the two processes' local sums; a shift of 2 raises."""
    from lte_gnu_radio_code_tpu_torch.parallel import mesh as pmesh

    jobs, ranks = two_procs
    for rank, got in enumerate(ranks):
        got = got["collectives"]
        assert got["mesh"] == {"dp": 1, "t": 4, "t_rank": rank, "t_local": 2}
        assert got["axis_index"].tolist() == [2 * rank, 2 * rank + 1]
        assert bool(got["shift 2 raises"])
        for name, (x, dim) in jobs["collectives"]["inputs"].items():
            for shift in (1, -1):
                want = pmesh.ppermute(x, shift, dim).narrow(dim, 2 * rank, 2)
                assert torch.equal(got[f"{name}.roll{shift:+d}"], want), (
                    name, shift)
            assert torch.equal(got[f"{name}.gather"],
                               pmesh.all_gather(x, dim))
            # each process sums its 2 shards, the group the 2 local sums
            assert torch.equal(got[f"{name}.sum"],
                               pmesh.psum(x.narrow(dim, 0, 2), dim) +
                               pmesh.psum(x.narrow(dim, 2, 2), dim))
            if not x.is_complex():
                assert torch.equal(got[f"{name}.min"], pmesh.pmin(x, dim))


@pytest.mark.parametrize("name", ["rx 64 t4", "rx 1024 t2",
                                  "rx 64 t4 noise"])
def test_rx_across_processes_equals_stacked_and_jax(two_procs, name):
    """The sharded RX with "t" over 2 processes: every rank's RxResult ==
    the stacked port's exactly, and == the JAX sharded RX on a "t" mesh of
    the virtual CPU devices (found, lock, delay, bits exact; peak 2e-3,
    phasors and CIR 2e-4); noise alone locks nowhere."""
    import jax.numpy as jnp

    from lte_gnu_radio_code_tpu.parallel import mesh as jmesh
    from lte_gnu_radio_code_tpu.parallel import sharded as jsharded
    from lte_gnu_radio_code_tpu.utils import params as jparams

    jobs, ranks = two_procs
    job = jobs[name]
    assert_replicated(ranks, name)
    got = ranks[0][name]
    assert got["mesh"]["t_local"] == job["t"] // 2
    assert_equal_fields(got, _stacked(job), name)
    cfg = jparams.GOLDEN64 if "64" in name else jparams.LTE1024
    x = job["x"].numpy()
    j = jsharded.make_sharded_rx(cfg, len(x), jmesh.time_mesh(job["t"]))(
        jnp.asarray(x))
    assert bool(got["found"]) == bool(j.found) == ("noise" not in name)
    if "noise" in name:
        # JAX's lock pointer is then cp + stride * INT_MAX; the port's trial
        # 0's (as tests/test_torch_parallel.py's no-lock case)
        assert not bool(got["phasors"].any()) and int(got["delay_idx"]) == 0
        return
    for f in ("found", "lock_ptr", "delay_idx", "hard_bits"):
        np.testing.assert_array_equal(
            got[f].numpy(), np.asarray(getattr(j, f)), err_msg=f)
    assert abs(float(got["peak"]) - float(j.peak)) < PEAK_ATOL
    for f in ("phasors", "chan_est_time"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(getattr(j, f)),
                                   atol=ATOL, rtol=0, err_msg=f)


def _jax_stream(job, name):
    import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, conftest)

    from lte_gnu_radio_code_tpu.parallel import mesh as jmesh
    from lte_gnu_radio_code_tpu.parallel import streaming as jstreaming
    from lte_gnu_radio_code_tpu.utils import params as jparams

    if job["kind"] == "reacq":
        cfg = jparams.GOLDEN64
        rx = jstreaming.ShardedReacqStreamingRx(cfg, job["chunk"],
                                                jmesh.time_mesh(job["t"]))
    else:
        table = "CFO_CASES" if "CFO" in name else "DSSS_CASES"
        cfg = jparams.config_from_case(getattr(jparams, table),
                                       0 if table == "CFO_CASES" else 4,
                                       snr_db=1e8)
        rx = jstreaming.ShardedLegacyStreamingRx(
            cfg, job["chunk"], jmesh.time_mesh(job["t"]),
            fo_range=job["fo_range"], dsss=job["dsss"])
    sig = job["x"].numpy()
    chunk = job["chunk"]
    buf = np.zeros(-(-len(sig) // chunk) * chunk, np.complex64)
    buf[:len(sig)] = sig
    outs = [rx.push(buf[i:i + chunk], n_real=max(0, min(chunk, len(sig) - i)))
            for i in range(0, len(buf), chunk)] + rx.finish()
    return outs, rx.state


@pytest.mark.parametrize("name", ["reacq t4", "legacy CFO_CASES t4",
                                  "legacy DSSS_CASES t2"])
def test_streams_across_processes_equal_stacked_and_jax(two_procs, name):
    """The sharded reacq and legacy streams with "t" over 2 processes:
    every rank's chunk outputs and carry == the stacked port's exactly, and
    == the JAX sharded receiver's chunk by chunk (tables exact, peaks 2e-3,
    phasors and channels 2e-4), with detections found."""
    jobs, ranks = two_procs
    job = jobs[name]
    assert_replicated(ranks, name)
    got = ranks[0][name]
    assert_equal_fields(got, _stacked(job), name)
    assert int(got["valid"].sum()) > 0
    jouts, jstate = _jax_stream(job, name)
    assert len(jouts) == got["valid"].shape[0]
    for i, jo in enumerate(jouts):
        for f in jo._fields:
            x, y = got[f][i].numpy(), np.asarray(getattr(jo, f))
            if x.dtype.kind in "fc":
                np.testing.assert_allclose(
                    x, y, atol=PEAK_ATOL if f == "peaks" else ATOL, rtol=0,
                    err_msg=f"chunk {i} {f}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"chunk {i} {f}")
    for f in jstate._fields:
        np.testing.assert_array_equal(got[f"state.{f}"].numpy(),
                                      np.asarray(getattr(jstate, f)),
                                      err_msg=f)


def _chain_cfg():
    from lte_gnu_radio_code_tpu_torch.parallel import sharded
    from lte_gnu_radio_code_tpu_torch.utils.params import OFDMConfig

    cfg = OFDMConfig(num_ofdm_symb=48).validate()
    while cfg.frame_len // 4 < sharded.halo_size(cfg):
        cfg = OFDMConfig(num_ofdm_symb=cfg.num_ofdm_symb * 2).validate()
    return cfg


def test_dp_t_chain_over_four_processes(tmp_path):
    """4 processes, dp 2 x t_procs 2 (t 4, 2 shards each), on a small
    GOLDEN64 chain with injected noise: each "t" group's ranks agree, the
    "dp" gather == chain_batch's and the stacked dp x t chain's BER, found
    and lock on the same noise, every frame locked with BER 0; a world
    that t_procs does not divide raises."""
    from lte_gnu_radio_code_tpu_torch.models import chain, rxofdm
    from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
    from lte_gnu_radio_code_tpu_torch.parallel import mesh as pmesh

    cfg = _chain_cfg()
    b = 4
    rng = np.random.default_rng(11)
    bits = torch.from_numpy(rng.integers(0, 2, (b, cfg.num_bits))
                            .astype(np.int32))
    n = cfg.frame_len + cfg.nfft - 1
    noise = torch.from_numpy((rng.standard_normal((b, n)) + 1j * rng.
                              standard_normal((b, n))).astype(np.complex64))
    jobs = {"chain": dict(kind="chain", t=4, t_procs=2,
                          cfg=dataclasses.asdict(cfg), bits=bits,
                          noise=noise)}
    ranks = spawn(jobs, 4, tmp_path)
    for rank, r in enumerate(ranks):
        assert r["uneven world raises"]
        got = r["chain"]
        assert got["mesh"] == {"dp": 2, "t": 4, "t_rank": rank % 2,
                               "t_local": 2}
        rows = slice(2 * (rank // 2), 2 * (rank // 2) + 2)
        for f in ("ber", "found", "lock"):
            assert torch.equal(got[f], got[f"all_{f}"][rows]), (rank, f)
            assert torch.equal(got[f"all_{f}"], ranks[0]["chain"][f"all_{f}"])
    got = ranks[0]["chain"]
    n_trials, num_patterns = rxofdm.plan_rx(cfg, n)
    ref = chain.chain_batch(cfg, chain.loopback_taps(cfg), n_trials,
                            num_patterns, bits, noise=noise)
    ber, found, lock = pchain.make_sharded_chain(
        cfg, pmesh.make_mesh(8, dp=2, device="cpu"))(bits, noise=noise)
    assert bool(got["all_found"].all()) and float(got["all_ber"].max()) == 0
    for mine, stacked, single in ((got["all_ber"], ber, ref.ber),
                                  (got["all_found"], found, ref.found),
                                  (got["all_lock"], lock, ref.lock_ptr)):
        assert torch.equal(mine, stacked) and torch.equal(mine, single)


def test_t_procs_that_do_not_split_raise(monkeypatch):
    """t_procs must divide the world and t; a single process has a world
    of one."""
    import torch.distributed as dist

    from lte_gnu_radio_code_tpu_torch.parallel import multihost

    with pytest.raises(ValueError, match="t_procs = 2"):
        multihost.multihost_mesh(t=4, device="cpu", t_procs=2)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 6)
    for t, t_procs in ((8, 4), (6, 4), (3, 2), (4, 0)):
        with pytest.raises(ValueError, match=f"t_procs = {t_procs}"):
            multihost.multihost_mesh(t=t, device="cpu", t_procs=t_procs)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
