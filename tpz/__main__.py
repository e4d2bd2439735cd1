"""CLI: python -m tpz {compress,decompress,bench,selftest} ...

The reference crate has no CLI (SURVEY.md §1); this maps the typed per-codec
configs (SURVEY.md §5 config row) onto flags.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpz",
                                description="tpz compression suite")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_io(sp):
        sp.add_argument("input", help="input file, or - for stdin")
        sp.add_argument("-o", "--output", default=None,
                        help="output file (default: stdout for -, else "
                             "input+suffix / stripped suffix)")
        sp.add_argument("-f", "--format", default="gzip",
                        help="gzip|zlib|deflate|bzip2|lh4..lh7")

    c = sub.add_parser("compress", help="compress a file")
    add_io(c)
    c.add_argument("-l", "--level", type=int, default=6)
    c.add_argument("-b", "--backend", default="auto",
                   choices=["auto", "oracle", "device"])
    d = sub.add_parser("decompress", help="decompress a file")
    add_io(d)
    d.add_argument("-b", "--backend", default="auto",
                   choices=["auto", "oracle", "device"])
    s = sub.add_parser("selftest", help="round-trip every format on synthetic data")
    s.add_argument("-n", type=int, default=1 << 16)
    b = sub.add_parser("bench", help="one-line JSON benchmark (bench.py)")
    b.add_argument("--bytes", type=int, default=None)
    args = p.parse_args(argv)

    if args.cmd == "bench":
        import os as _os

        if args.bytes:
            _os.environ["TPZ_BENCH_BYTES"] = str(args.bytes)
        import importlib.util as _ilu
        import pathlib

        spec = _ilu.spec_from_file_location(
            "tpz_bench", pathlib.Path(__file__).parent.parent / "bench.py")
        mod = _ilu.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main()
        return 0

    import tpz.api as api

    if args.cmd == "selftest":
        from tpz.utils import corpus

        data = corpus.mixed(args.n)
        ok = True
        for fmt in api.formats():
            t0 = time.time()
            comp = api.compress(data, fmt)
            t1 = time.time()
            good = api.decompress(comp, fmt) == data
            t2 = time.time()
            ok &= good
            print(f"{fmt:8s} {'OK ' if good else 'FAIL'} "
                  f"ratio={len(comp)/len(data):.3f} "
                  f"enc={len(data)/max(t1-t0,1e-9)/1e6:.1f}MB/s "
                  f"dec={len(data)/max(t2-t1,1e-9)/1e6:.1f}MB/s")
        return 0 if ok else 1

    raw = (sys.stdin.buffer.read() if args.input == "-"
           else open(args.input, "rb").read())
    suffix = {"gzip": ".gz", "zlib": ".zz", "deflate": ".deflate",
              "bzip2": ".bz2"}.get(args.format, "." + args.format)
    t0 = time.time()
    if args.cmd == "compress":
        out = api.compress(raw, args.format, level=args.level,
                           backend=args.backend)
        default_out = None if args.input == "-" else args.input + suffix
    else:
        out = api.decompress(raw, args.format, backend=args.backend)
        default_out = (args.input[: -len(suffix)]
                       if args.input.endswith(suffix) else
                       (None if args.input == "-" else args.input + ".out"))
    dt = time.time() - t0
    dest = args.output or default_out
    if dest is None or dest == "-":
        sys.stdout.buffer.write(out)
    else:
        open(dest, "wb").write(out)
    print(json.dumps({
        "cmd": args.cmd, "format": args.format, "in_bytes": len(raw),
        "out_bytes": len(out), "seconds": round(dt, 4),
        "mb_per_s": round(len(raw) / max(dt, 1e-9) / 1e6, 2),
        "output": dest or "<stdout>",
    }), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
