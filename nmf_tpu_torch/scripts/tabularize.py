"""Aggregate per-run eval stats into one table (host only; the port's
copy of ``nmf_tpu/scripts/tabularize.py``).

Walks experiment log folders, loads every ``stats*.yaml`` the evaluator
wrote, and produces a table keyed by experiment/scene with the metric
columns ``psnr, ssim, l_alex, l_vgg, envmap_psnr_top, norm_err, ...``.

Usage:
    python -m nmf_tpu_torch.scripts.tabularize LOGDIR [--keys psnr,ssim,...]
                                                        [--csv out.csv]
                                                        [--time-to-db 30]

--time-to-db N additionally reports, per run, the first wall-clock second
and iteration at which the train PSNR telemetry (metrics.jsonl) reached
N dB.
"""
import argparse
import json
import sys
from pathlib import Path

DEFAULT_KEYS = ["psnr", "ssim", "l_alex", "l_vgg", "norm_err",
                "envmap_psnr", "envmap_psnr_top", "envmap_smape_top",
                "envmap_ssim_top", "tint_psnr"]


def _load_yaml(path: Path):
    try:
        import yaml

        with open(path) as f:
            return yaml.safe_load(f)
    except ImportError:
        # our stats files are flat "key: value" yaml; parse by hand
        out = {}
        for line in path.read_text().splitlines():
            if ":" in line:
                k, _, v = line.partition(":")
                try:
                    out[k.strip()] = float(v.strip())
                except ValueError:
                    out[k.strip()] = v.strip()
        return out


def collect(logdir: Path):
    """Return {run_name: {metric: value}} from every stats*.yaml under
    logdir (searched recursively, newest file wins per run dir)."""
    rows = {}
    for stats in sorted(logdir.rglob("stats*.yaml")):
        run = stats.parent.relative_to(logdir)
        data = _load_yaml(stats)
        if isinstance(data, dict):
            row = rows.setdefault(str(run), {})
            for k, v in data.items():
                # a stats yaml may store per-image lists; mean them
                if isinstance(v, list) and v and all(
                        isinstance(x, (int, float)) for x in v):
                    row[k] = sum(v) / len(v)
                elif isinstance(v, (int, float)):
                    row[k] = v
        # run-level scalars (envmap_psnr_top etc., the eval summary) live in
        # mean.txt next to the stats yaml; merge without clobbering
        mean_txt = stats.parent / "mean.txt"
        if mean_txt.exists():
            try:
                summary = json.loads(mean_txt.read_text().replace("'", '"'))
                row = rows.setdefault(str(run), {})
                for k, v in summary.items():
                    if isinstance(v, (int, float)):
                        row.setdefault(k, v)
            except (ValueError, json.JSONDecodeError):
                pass
    return rows


def time_to_db(logdir: Path, threshold: float):
    """{run: {t_s, step}} for the first metrics.jsonl record with train
    psnr >= threshold (records carry `t` = seconds since run start)."""
    out = {}
    for mfile in sorted(logdir.rglob("metrics.jsonl")):
        run = str(mfile.parent.relative_to(logdir))
        for line in mfile.read_text().splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("psnr", -1e9) >= threshold:
                out[run] = {"t_s": rec.get("t"), "step": rec.get("step")}
                break
        else:
            out.setdefault(run, None)
    return out


def render_table(rows, keys):
    headers = ["run"] + keys
    lines = [" | ".join(headers), " | ".join("---" for _ in headers)]
    means = {k: [] for k in keys}
    for run in sorted(rows):
        vals = []
        for k in keys:
            v = rows[run].get(k)
            if v is None:
                vals.append("-")
            else:
                vals.append(f"{v:.4g}")
                means[k].append(v)
        lines.append(" | ".join([run] + vals))
    mean_row = ["mean"] + [
        f"{sum(means[k]) / len(means[k]):.4g}" if means[k] else "-"
        for k in keys]
    lines.append(" | ".join(mean_row))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logdir", type=Path)
    ap.add_argument("--keys", default=",".join(DEFAULT_KEYS))
    ap.add_argument("--csv", type=Path, default=None)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--time-to-db", type=float, default=None,
                    help="report first wall-second/iter reaching this "
                         "train PSNR per run (metrics.jsonl)")
    args = ap.parse_args(argv)

    if args.time_to_db is not None:
        ttd = time_to_db(args.logdir, args.time_to_db)
        for run in sorted(ttd):
            hit = ttd[run]
            if hit is None:
                print(f"{run}: never reached {args.time_to_db:g} dB")
            else:
                print(f"{run}: {args.time_to_db:g} dB at "
                      f"t={hit['t_s']:.1f}s step={hit['step']}")
        if not ttd:
            print(f"no metrics.jsonl found under {args.logdir}",
                  file=sys.stderr)

    keys = [k for k in args.keys.split(",") if k]
    rows = collect(args.logdir)
    if not rows:
        print(f"no stats*.yaml found under {args.logdir}", file=sys.stderr)
        return 0 if args.time_to_db is not None else 1
    if args.json:
        print(json.dumps(rows, indent=2, sort_keys=True))
    else:
        print(render_table(rows, keys))
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(",".join(["run"] + keys) + "\n")
            for run in sorted(rows):
                f.write(",".join([run] + [str(rows[run].get(k, ""))
                                          for k in keys]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
