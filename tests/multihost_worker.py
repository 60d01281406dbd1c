"""Worker for the two-process jax.distributed smoke test (run by
test_multihost.py, one instance per simulated host).

Forms a 2-process global mesh of 8 virtual CPU devices (4 per process),
runs the production sharded parse (shard_map + psum over the global data
axis), allgathers the device candidates, and on process 0 composes the DP
frame body and roundtrips it.  Bit-identity with the single-process DP
output is asserted by the parent test.

SURVEY.md §2.7: the multi-host path is the same collectives-as-backend
design as single-host DP; only the mesh spans processes (DCN in prod,
localhost gRPC here).
"""

import os
import sys

# Each worker is a CPU process with 4 virtual devices: main() pins the
# platform before any backend starts, so workers never open an accelerator.
_flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
          if "xla_force_host_platform_device_count" not in f]
os.environ["XLA_FLAGS"] = " ".join(
    _flags + ["--xla_force_host_platform_device_count=4"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    coordinator = sys.argv[1]
    process_id = int(sys.argv[2])
    out_path = sys.argv[3]

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=2, process_id=process_id)

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zstdsharp_tpu.parallel.pipeline import (make_mesh, make_sharded_parse,
                                                 shard_blocks)

    devs = jax.devices()
    assert len(devs) == 8, f"global devices {len(devs)}"
    assert jax.process_count() == 2

    rng = np.random.default_rng(11)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta "]
    data = b"".join(words[i] for i in rng.integers(0, 4, 60000))

    mesh = make_mesh(devs)
    blocks, n_valid, n_blocks = shard_blocks(data, len(devs))

    # Global arrays from per-process local shards: each process owns the
    # rows its 4 local devices hold.
    sharding = NamedSharding(mesh, P("data", None))
    g_blocks = jax.make_array_from_process_local_data(sharding, blocks)
    g_nvalid = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), n_valid)

    parse = make_sharded_parse(mesh)
    out = parse(g_blocks, g_nvalid)

    # The psum rode the cross-process axis, so the replicated output's
    # local shard already holds the GLOBAL count; the parent test asserts
    # both processes report the same value.
    g_cand_count = int(np.asarray(
        out["global_candidates"].addressable_data(0)).reshape(-1)[0])

    # Gather the sharded results to every host, then compose on process 0.
    ps_all = multihost_utils.process_allgather(out["ps"], tiled=True)
    cand_all = multihost_utils.process_allgather(out["cand"], tiled=True)

    result = {"ok": False}
    if process_id == 0:
        from zstdsharp_tpu import native
        from zstdsharp_tpu import constants as C
        from zstdsharp_tpu.encode.frame import (_block_header,
                                                _write_frame_header)
        from zstdsharp_tpu.decode.frame import decompress

        src = np.frombuffer(data, dtype=np.uint8)
        cand_by_pos = np.empty_like(np.asarray(cand_all))
        np.put_along_axis(cand_by_pos, np.asarray(ps_all).astype(np.int64),
                          np.asarray(cand_all), axis=1)
        body = native.dp_frame_body(src, cand_by_pos[:n_blocks].reshape(-1),
                                    C.ZSTD_BLOCKSIZE_MAX)
        frame = bytearray(_write_frame_header(
            len(src), C.ZSTD_BLOCKSIZELOG_MAX, False, True))
        frame += body
        assert decompress(bytes(frame)) == data, "multihost roundtrip"
        result = {"ok": True, "frame_len": len(frame),
                  "global_candidates": g_cand_count}
        with open(out_path, "w") as f:
            import json
            json.dump(result, f)
    else:
        # non-zero processes only validate the collective view
        with open(out_path, "w") as f:
            import json
            json.dump({"ok": True, "global_candidates": g_cand_count}, f)

    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
