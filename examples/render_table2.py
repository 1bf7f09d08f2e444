"""Render `bench.py --mode table2` output as the reference-comparison
markdown table (docs/TABLE2.md).

    python bench.py --mode table2 --full > /tmp/t2.json
    python examples/render_table2.py /tmp/t2.json --write-docs

Reference cells are the committed notebook output
(encrypt_test/final_big_table.ipynb cell 30; BASELINE.md section 1,
AWS c5.4xlarge 16 vCPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# (algorithm, elements) -> (ct_size_str, enc_s, dec_s, add_s) from the
# reference notebook (BASELINE.md section 1)
REF = {
    ("paillier", 16384): ("8.00 MB", 23.84, 13.83, 6.72),
    ("paillier+batch", 16384): ("96.49 KB", 0.49, 0.38, 0.71),
    ("bfv", 16384): ("513.09 MB", 35.62, 35.28, 7.49),
    ("bfv+batch", 16384): ("1.00 MB", 1.15, 1.14, 0.01),
    ("ckks", 16384): ("6.60 GB", 76.28, 52.79, 212.57),
    ("ckks+batch", 16384): ("1.65 MB", 0.02, 0.01, 0.06),
    ("flashe", 16384): ("40.02 KB", 2.63, 2.40, 7.12),
    ("paillier+batch", 65536): ("385.92 KB", 1.33, 0.83, 0.73),
    ("bfv+batch", 65536): ("4.00 MB", 1.33, 1.25, 0.05),
    ("ckks+batch", 65536): ("6.60 MB", 0.08, 0.06, 0.22),
    ("flashe", 65536): ("160.02 KB", 2.64, 2.40, 7.14),
    ("paillier+batch", 262144): ("1.51 MB", 4.69, 2.81, 1.69),
    ("bfv+batch", 262144): ("16.00 MB", 1.76, 1.77, 0.20),
    ("ckks+batch", 262144): ("26.40 MB", 0.33, 0.23, 0.95),
    ("flashe", 262144): ("640.02 KB", 2.42, 2.42, 7.33),
}


def _size(b):
    if b >= 1 << 30:
        return f"{b / (1 << 30):.2f} GB"
    if b >= 1 << 20:
        return f"{b / (1 << 20):.2f} MB"
    return f"{b / 1024:.2f} KB"


def _cell(ours, ref):
    """One timing cell: our median, with the speedup over the reference."""
    if ours is None:
        return f"— (ref {ref} s)" if ref is not None else "—"
    if ref is None:
        return f"{ours:.4g} s"
    return f"{ours:.4g} s ({ref / ours:.1f}x)"


def _device(d) -> str:
    if not d:
        return "an unnamed device"
    return f"{d['count']} x {d['device_kind']} ({d['platform']})"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("json_path")
    ap.add_argument("--card", default="",
                    help="the card's name and power limit, as nvidia-smi "
                         "--query-gpu=name,power.limit prints them")
    ap.add_argument("--write-docs", action="store_true")
    args = ap.parse_args(argv)

    rows = device = None
    with open(args.json_path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and '"table2"' in line:
                d = json.loads(line)
                rows, device = d["rows"], d.get("device")
    if rows is None:
        raise SystemExit("no table2 JSON line found")

    where = _device(device) + (f", {args.card}" if args.card else "")
    lines = [
        "# Crypto comparison table (the reference's Table-2 benchmark)",
        "",
        "Reproduction of `encrypt_test/final_big_table.ipynb` cell 30 on "
        f"{where} (`python bench.py --mode table2 [--full]`); "
        "reference cells are the committed notebook output on a "
        "c5.4xlarge (16 vCPU).  '(Nx)' = speedup over the reference "
        "cell; '—' = not timed in that run (exact ciphertext sizes are "
        "always computed).",
        "",
        "| Vector len | Algorithm | Ciphertext (ours / ref) | Inflation "
        "| Encrypt | Add (10 cts) | Decrypt | Correct |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        base_alg = r["algorithm"].replace(" (extrapolated)", "")
        key = (base_alg, r["elements"])
        ref = REF.get(key)
        refsz = ref[0] if ref else "—"
        lines.append(
            f"| {r['elements']:,} | {r['algorithm']} | "
            f"{_size(r['ciphertext_bytes'])} / {refsz} | "
            f"{r['inflation_x']}x | "
            f"{_cell(r['encrypt_s'], ref[1] if ref else None)} | "
            f"{_cell(r['add10_s'], ref[3] if ref else None)} | "
            f"{_cell(r['decrypt_s'], ref[2] if ref else None)} | "
            f"{'yes' if r['correct'] else 'NO'} |")
    lines += [
        "",
        "Notes: each cell is the median of three calls after one warm-up "
        "call, each ended by block_until_ready.  Ciphertext sizes differ "
        "from the reference where the schemes' parameters legitimately "
        "differ (documented in docs/PARITY.md): Paillier packs 102 20-bit "
        "lanes per 4096-bit ciphertext, our native BFV uses RNS ~30-bit "
        "primes, CKKS ships symmetric (c0, a) pairs.  '(extrapolated)' "
        "rows time a measured sub-slice (512-2048 elements, or the full "
        "first size for paillier) and scale linearly — the per-"
        "ciphertext work is independent, so cost is linear in n; run "
        "`--full` for end-to-end timings of those rows.",
        "",
    ]
    out = "\n".join(lines)
    if args.write_docs:
        path = os.path.join(os.path.dirname(__file__), "..", "docs",
                            "TABLE2.md")
        with open(path, "w") as f:
            f.write(out)
        print(f"wrote {os.path.normpath(path)}", file=sys.stderr)
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
