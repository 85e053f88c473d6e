"""Worker process for the 2-process (2-host-shaped) integration test.

Each worker initialises the distributed JAX runtime (gloo CPU collectives,
4 virtual devices per process), builds the process-spanning 8-device mesh,
and runs BOTH sharded receivers — the time-sharded blind chain and the
frame-parallel pilot receiver — SER-gated across the process boundary.
This is the execution shape of a multi-host deployment: the same program
in every process, collectives crossing processes over the distributed
runtime.

Replaces the role of the reference's ZMQ worker pool
(qampy/core/processing.py:41-149), which shipped pickled ndarrays to
worker processes; here the runtime moves shards and the program is SPMD.

Usage: python mp_worker.py <process_id> <num_processes> <coordinator>
"""
import sys


def main(process_id, num_processes, coordinator):
    from qampy_tpu.parallel import init_distributed, make_mesh, sharded
    init_distributed(coordinator_address=coordinator,
                     num_processes=num_processes, process_id=process_id,
                     local_device_count=4)
    import jax
    import jax.random as jr
    import numpy as np
    import qampy_tpu as qt
    from qampy_tpu import impairments

    assert jax.process_count() == num_processes
    n_devices = num_processes * 4
    assert len(jax.devices()) == n_devices
    mesh = make_mesh()

    # ---- time-sharded blind chain across the process boundary ----------
    # identical host-side TX in every process (same seed)
    L = 512 * n_devices
    sig = qt.SignalQAMGrayCoded(16, L // 2, nmodes=2, fb=25e9, seed=1)
    up = sig.resample(50e9, beta=0.1)
    s = impairments.change_snr(up, 30, key=jr.PRNGKey(0))
    E = sharded.shard_signal(np.asarray(s).astype(np.complex64), mesh)
    chain = sharded.make_sharded_rx_chain(
        mesh, os=2, mu1=1e-3, mu2=1e-3, M=16, Ntaps=9,
        methods=("cma", "rde"), rounds=2, Niter=2, bps_angles=32, bps_N=14,
        block_size=128)
    assert chain.backend_info["family"] == "xla", chain.backend_info
    Eout, ph, evm = chain(E)
    out = sharded.fetch_global(Eout, mesh)
    ser = np.asarray(sig.replace(samples=out).cal_ser())
    assert np.all(ser < 1e-2), "multi-process blind-chain SER: %s" % ser

    # ---- frame-parallel pilot receiver across the process boundary -----
    psig = qt.SignalWithPilots(16, 4096, 256, 64, nframes=n_devices + 2,
                               nmodes=2, fb=24e9, seed=3)
    ps2 = psig.resample(2 * psig.fb, beta=0.1, renormalise=True)
    ps2 = impairments.simulate_transmission(ps2, snr=25,
                                            roll_frame_sync=True,
                                            key=jr.PRNGKey(4))
    pchain = sharded.make_sharded_pilot_rx(
        mesh, np.asarray(psig.pilot_seq), np.asarray(psig.ph_pilots),
        psig.frame_len, psig.pilot_ins_rat, frames_per_device=1,
        os=2, M=16, nmodes=2, Ntaps=17, Niter=10, cpe_avg=3)
    Erep = sharded.replicate_signal(
        np.asarray(ps2.samples).astype(np.complex64), mesh)
    pdata, pshift, pcorr = pchain(Erep)
    pout_host = sharded.fetch_global(pdata, mesh)
    pout = psig.get_data().replace(samples=pout_host)
    pser = np.asarray(pout.cal_ser(synced=True))
    assert np.all(pser < 1e-2), "multi-process pilot-chain SER: %s" % pser

    print("MP_WORKER_OK process=%d blind_ser=%s pilot_ser=%s"
          % (process_id, ser.tolist(), pser.tolist()), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
