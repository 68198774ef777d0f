"""CLI entry point: `python -m tpu_qe_torch <subcommand>`.

  verify   scene -> morton -> LSD radix sort on the device, sortedness and
           all-zeros checks, keys and payload order bit-exact against the
           C++ pipeline oracle; prints VERIFY PASS / VERIFY FAIL (exit 0/1)
  dump     golden-file dump of morton codes + triangle indices
  bench    headline benchmark (tpu_qe_torch/bench/headline.py)
  info     device + configuration report

Every subcommand that touches a device takes --device (default cuda); a
CUDA device on a machine without CUDA raises instead of running elsewhere.
"""

from __future__ import annotations

import argparse
import logging
import sys

log = logging.getLogger("tpu_qe_torch")


def _cmd_verify(args) -> int:
    import numpy as np
    import torch

    from tpu_qe_torch import morton, native
    from tpu_qe_torch.bits import is_sorted_u64, masked_key
    from tpu_qe_torch.config import (EngineConfig, SceneConfig, SortConfig,
                                     resolve_device)
    from tpu_qe_torch.pipeline import scene_tensors
    from tpu_qe_torch.sort import sort_u64
    from tpu_qe_torch.utils.profiling import marker, trace_session

    dev = resolve_device(args.device)
    cfg = EngineConfig(
        sort=SortConfig(backend=args.backend,
                        bits_per_pass=args.bits_per_pass,
                        num_passes=args.num_passes),
        scene=SceneConfig(num_vertices=args.vertices,
                          num_triangles=args.triangles, seed=args.seed),
        trace_dir=args.trace_dir,
    )
    sc = cfg.scene
    log.info("verify run: %d vertices, %d triangles, seed %d, backend %s, "
             "device %s", sc.num_vertices, sc.num_triangles, sc.seed,
             cfg.sort.backend, dev)

    verts_t, tris_t, params = scene_tensors(sc, dev)

    with trace_session(cfg.trace_dir):
        with marker("compute morton code"):
            code = morton.encode(verts_t, tris_t, params)
        idx = torch.arange(sc.num_triangles, dtype=torch.int32, device=dev)
        with marker("radix sort"):
            skey, (sidx,) = sort_u64(code, idx, backend=cfg.sort.backend,
                                     key_bits=cfg.sort.key_bits,
                                     bits_per_pass=cfg.sort.bits_per_pass,
                                     block=cfg.sort.block)
        mlo, mhi = masked_key(skey.lo, skey.hi, cfg.sort.key_bits)
        ok_sorted = bool(is_sorted_u64(mlo, mhi))

    keys_np = skey.to_numpy()
    idx_np = sidx.cpu().numpy().view(np.uint32)

    # All-zeros detector (reference main.rs:852-864).
    all_zeros = int(np.count_nonzero(keys_np == 0)) == sc.num_triangles

    oracle_codes, oracle_idx = native.pipeline_oracle(
        sc.num_vertices, sc.num_triangles, sc.seed)
    keys_exact = bool(np.array_equal(keys_np, oracle_codes))
    idx_exact = bool(np.array_equal(idx_np, oracle_idx))

    if ok_sorted and not all_zeros:
        log.info("Sorted !!!!!!!!!")
    else:
        bad = int(np.count_nonzero(keys_np[1:] < keys_np[:-1]))
        log.error("Not sorted!!! %d", bad)
    log.info("oracle keys bit-exact: %s, payload order exact: %s",
             keys_exact, idx_exact)

    ok = ok_sorted and not all_zeros and keys_exact and idx_exact
    print("VERIFY PASS" if ok else "VERIFY FAIL")
    return 0 if ok else 1


def _cmd_dump(args) -> int:
    from tpu_qe_torch import native
    from tpu_qe_torch.utils.dump import dump_indices, dump_morton_codes

    verts, tris, smin, smax = native.scene_generate(
        args.vertices, args.triangles, args.seed)
    gen = native.MortonGen(smin, smax)
    codes = gen.encode(verts, tris, quirk=args.quirk_lut)
    p1 = dump_morton_codes(codes, args.codes_path)
    p2 = dump_indices(tris, args.indices_path)
    print(f"wrote {p1}\nwrote {p2}")
    return 0


def _cmd_bench(args) -> int:
    from tpu_qe_torch.bench import headline
    return headline.main(args.rest)


def _cmd_info(args) -> int:
    import torch

    from tpu_qe_torch.config import EngineConfig, resolve_device

    dev = resolve_device(args.device)
    print(f"torch: {torch.__version__}, cuda: {torch.version.cuda}")
    print(f"device: {dev}")
    if dev.type == "cuda":
        from tpu_qe_torch.bench.sol import card, hbm_peak_bytes_per_s
        print(f"card: {card()}")
        print(f"hbm_peak: {hbm_peak_bytes_per_s() / 1e9:.0f} GB/s")
    print(f"config: {EngineConfig.from_env()}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpu_qe_torch")
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pv = sub.add_parser("verify", help="headless verify run (device vs oracle)")
    pv.add_argument("--vertices", type=int, default=1000)
    pv.add_argument("--triangles", type=int, default=3000)
    pv.add_argument("--seed", type=int, default=7)
    pv.add_argument("--backend", type=str, default="radix",
                    choices=["radix", "torch"],
                    help="sort backend: the CUDA radix kernels, or the "
                         "stable torch.sort baseline")
    pv.add_argument("--bits-per-pass", type=int, default=8)
    pv.add_argument("--num-passes", type=int, default=8,
                    help="e.g. --bits-per-pass 6 --num-passes 11 for the "
                         "reference's 6-bit test variant")
    pv.add_argument("--trace-dir", type=str, default=None)
    pv.add_argument("--device", type=str, default="cuda")
    pv.set_defaults(fn=_cmd_verify)

    pd = sub.add_parser("dump", help="golden-file dump (morton codes, indices)")
    pd.add_argument("--vertices", type=int, default=1000)
    pd.add_argument("--triangles", type=int, default=3000)
    pd.add_argument("--seed", type=int, default=7)
    pd.add_argument("--quirk-lut", action="store_true",
                    help="consume the LUTs like the shipped reference "
                         "kernel (i*3 byte shift) instead of the resolved "
                         "i*8 layout")
    pd.add_argument("--codes-path", type=str, default="morton_codes.txt")
    pd.add_argument("--indices-path", type=str, default="indices.txt")
    pd.set_defaults(fn=_cmd_dump)

    pb = sub.add_parser("bench", add_help=False,
                        help="headline benchmark (options: see "
                             "python -m tpu_qe_torch.bench.headline -h)")
    pb.set_defaults(fn=_cmd_bench)

    pi = sub.add_parser("info", help="device + config report")
    pi.add_argument("--device", type=str, default="cuda")
    pi.set_defaults(fn=_cmd_info)

    args, rest = parser.parse_known_args(argv)
    if args.cmd == "bench":
        args.rest = [a for a in rest if a != "--"]
    elif rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
