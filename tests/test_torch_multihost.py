"""Two real processes of the PyTorch port over gloo on the CPU: each runs
``parallel/multihost.py``'s init and mesh with the dp x t sharded chain
(dp = 2 processes, t = 2 shards stacked in each), on the configuration of
the JAX package's two-process test (tests/multihost_worker.py).  Every
frame on every process locks with BER 0, and the results gathered over
the group equal one process's chain on the same injected noise.

Run as a script, this file is the worker:
    test_torch_multihost.py <process_id> <num_processes> <coordinator> <out>
"""

import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
FRAMES_PER_PROCESS = 2
T_SHARDS = 2


def _config():
    from lte_gnu_radio_code_tpu_torch.parallel import sharded
    from lte_gnu_radio_code_tpu_torch.utils.params import OFDMConfig

    cfg = OFDMConfig(num_ofdm_symb=48).validate()
    while cfg.frame_len // T_SHARDS < sharded.halo_size(cfg):
        cfg = OFDMConfig(num_ofdm_symb=cfg.num_ofdm_symb * 2).validate()
    return cfg


def _inputs(cfg, frames):
    """Bits and noise of the global batch, from one seed on every process."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (frames, cfg.num_bits)).astype(np.int32)
    n = cfg.frame_len + cfg.nfft - 1
    noise = (rng.standard_normal((frames, n)) +
             1j * rng.standard_normal((frames, n))).astype(np.complex64)
    return torch.from_numpy(bits), torch.from_numpy(noise)


def worker(pid: int, nproc: int, coord: str, out: str) -> None:
    from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
    from lte_gnu_radio_code_tpu_torch.parallel import multihost

    assert multihost.init_distributed(coord, nproc, pid, device="cpu")
    mesh = multihost.multihost_mesh(t=T_SHARDS, device="cpu")
    assert mesh.shape == {"dp": nproc, "t": T_SHARDS}
    cfg = _config()
    bits, noise = _inputs(cfg, FRAMES_PER_PROCESS * nproc)
    ber, found, lock = pchain.make_sharded_chain(cfg, mesh)(bits,
                                                            noise=noise)
    assert len(ber) == FRAMES_PER_PROCESS, ber.shape
    assert bool(found.all()), f"proc {pid}: sync lock failed"
    assert bool((ber == 0).all()), f"proc {pid}: nonzero BER {ber}"
    ber, found, lock = multihost.gather_frames(mesh, ber, found, lock)
    if pid == 0:
        np.savez(out, ber=ber.numpy(), found=found.numpy(),
                 lock=lock.numpy())
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK pid={pid} procs={nproc} mesh=dp{nproc}xt{T_SHARDS} "
          f"frames={FRAMES_PER_PROCESS * nproc}", flush=True)


@pytest.mark.parametrize("process_id, local_rank, device, card, backend", [
    (5, None, None, 1, "nccl"),          # 5 % 4 cards
    (5, "3", None, 3, "nccl"),           # the launcher's LOCAL_RANK
    (5, "3", "cuda:2", 2, "nccl"),       # the caller's card
    (1, None, "cpu", None, "gloo"),
])
def test_init_picks_the_process_card(monkeypatch, process_id, local_rank,
                                     device, card, backend):
    """On a host of four cards each process makes its own card current
    before the group starts, and the mesh lies on it."""
    import torch.distributed as dist
    from lte_gnu_radio_code_tpu_torch.parallel import multihost

    current, calls = [0], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: current.__setitem__(0, i))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert multihost.init_distributed("127.0.0.1:29500", 8, process_id,
                                      device=device)
    (args, kw), = calls
    assert args == (backend,)
    assert kw == dict(init_method="tcp://127.0.0.1:29500", world_size=8,
                      rank=process_id)
    if card is None:
        assert current[0] == 0
        return
    assert current[0] == card
    mesh = multihost.multihost_mesh(t=2)
    assert mesh.device == torch.device("cuda", card)
    assert mesh.shape == {"dp": 1, "t": 2}      # no group was started


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_chain(tmp_path):
    from lte_gnu_radio_code_tpu_torch.parallel import chain as pchain
    from lte_gnu_radio_code_tpu_torch.parallel import mesh as pmesh

    coord = f"127.0.0.1:{_free_port()}"
    out = tmp_path / "gathered.npz"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(pid), "2", coord, str(out)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{text}"
        assert f"MULTIHOST_OK pid={pid} procs=2" in text, text

    cfg = _config()
    bits, noise = _inputs(cfg, 2 * FRAMES_PER_PROCESS)
    mesh = pmesh.make_mesh(2 * T_SHARDS, dp=2, device="cpu")
    ber, found, lock = pchain.make_sharded_chain(cfg, mesh)(bits,
                                                            noise=noise)
    got = np.load(out)
    np.testing.assert_array_equal(got["ber"], ber.numpy())
    np.testing.assert_array_equal(got["found"], found.numpy())
    np.testing.assert_array_equal(got["lock"], lock.numpy())


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
