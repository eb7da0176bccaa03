"""Interactive motion viewer CLI (port of ``scripts/view_motion.py``): one
self-contained HTML file of a take or of an evaluation record.

    # a take of a qpos bank (the clip generators' banks, training data)
    python -m kinpoly_tpu_torch.scripts.view_motion \\
        --bank data_bank/action_takes.pkl --take push-00 [--out push.html]

    # an eval_ar_policy record: predicted against ground truth, with the
    # simulated objects
    python -m kinpoly_tpu_torch.scripts.view_motion \\
        --result results_r5/statear/kin_poly/results/0800_wild_take0_coverage_full.pkl

Banks and records are read through ``data.banks.read_bank``, so a joblib
file and a plain pickle both load. The humanoid is
``synthetic_spec(with_objects=True)``, whose five objects are in the
reference scene's order (chair, box, table, Can, step). A take's or a
record's single object pose (T, 7) goes into the slot of its action's
object; the other objects are parked at x = 100 (i + 1); a push take's
``table_pose`` fills slot 2. FK runs on ``--device`` (default cuda).
Without ``--out`` a bank's view is written as ``<take>.html`` in the
temporary directory, a record's beside the record.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import synthetic_spec
from kinpoly_tpu_torch.data.banks import read_bank
from kinpoly_tpu_torch.metrics import pose_metrics as pm
from kinpoly_tpu_torch.utils.html_viewer import export_html


def place_objects(spec, obj_pose: np.ndarray, action: str) -> np.ndarray:
    """One object's poses (T, 7) -> every object slot (T, n_obj, 7): the
    action's object there, the others parked at x = 100 (i + 1)."""
    T = obj_pose.shape[0]
    full = np.zeros((T, len(spec.objects), 7), np.float32)
    full[:, :, 0] = np.arange(len(spec.objects))[None] * 100 + 100
    full[:, :, 3] = 1
    if action in pm.ACTIONS:
        full[:, int(pm.action_object_indices(spec)[
            pm.ACTIONS.index(action)])] = obj_pose[:, :7]
    return full


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bank", default=None, help="qpos bank pickle")
    p.add_argument("--take", default=None, help="take name inside the bank")
    p.add_argument("--result", default=None, help="eval result pickle (pred/gt)")
    p.add_argument("--out", default=None, help="output html (default: derived)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    spec = synthetic_spec(with_objects=True)

    if args.result:
        blob = read_bank(args.result)
        seqs = {"pred": np.asarray(blob["pred"])}
        if "gt" in blob:
            seqs["gt"] = np.asarray(blob["gt"])
        obj = blob.get("obj_pose")
        if obj is not None and np.asarray(obj).ndim == 2:
            obj = place_objects(spec, np.asarray(obj), blob.get("action", "sit"))
        out = args.out or os.path.splitext(args.result)[0] + ".html"
        title = os.path.basename(args.result)
    elif args.bank:
        bank = read_bank(args.bank)
        name = args.take or next(iter(bank))
        take = bank[name]
        seqs = {name: np.asarray(take["qpos"])}
        obj = None
        if "obj_pose" in take:
            o = np.asarray(take["obj_pose"])
            obj = place_objects(spec, o, take.get("action", "sit"))
            if o.shape[-1] >= 14:
                obj[:, 2] = o[:, 7:14]
            elif "table_pose" in take:
                obj[:, 2] = np.asarray(take["table_pose"])[:, :7]
        out = args.out or os.path.join(tempfile.gettempdir(), f"{name}.html")
        title = name
    else:
        p.error("--bank or --result required")

    path = export_html(spec, seqs, out, obj_seq=obj, title=title, device=device)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
