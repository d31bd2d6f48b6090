"""Where does a train cell's gradient gap come from?

    python3 stereobench/tools/grad_look.py --workload speckle_verify.train \\
        --seed 25617070862

Runs the cell's first steps as ``loops/train.py`` does and, at each,
compares the program's camera gradient with the reference's: the gap of
the norms, the share of the squared difference and of the squared
reference gradient held by the largest pixels, and, at the pixels whose
gradient differs most, the margin between the largest and the second
largest cost of the windows around them and the soft-argmax weight of
the runner-up.  Prints one JSON line a step.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from stereobench import harness  # noqa: E402
from stereobench.loops import train as train_loop  # noqa: E402
from stereobench.reference import train as ref_train  # noqa: E402
from stereobench.reference import zncc  # noqa: E402
from stereobench.traffic import generator  # noqa: E402

F64 = torch.float64


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="speckle_verify.train")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top", type=int, default=20)
    args = p.parse_args()
    from custereomatching_tpu_torch.models import optimize

    cell = harness.resolve(harness.load_manifest(), args.workload)
    cfg, mix = cell.config, cell.traffic
    device = harness.card(cell.chips)
    H, W, B = int(cfg["height"]), int(cfg["width"]), int(cfg["frames_per_call"])
    sc = generator.scenes(args.seed, B, H, W, cfg["scene"], device)
    camera0 = sc.camera + generator.perturbation(
        args.seed, sc.camera.shape, float(mix["start_noise"]), device)
    model = train_loop.recording_matcher(harness.stereo_config(cfg))
    state = optimize.init_state(camera0, optimize.adam(
        float(mix["learning_rate"])))
    step_fn = optimize.make_train_step(model)
    for i in range(args.steps):
        before = state.camera.detach().clone()
        model.recording = True
        state, _ = step_fn(state, sc.projector, sc.disparity)
        model.recording = False
        g_p = state.camera.grad.detach().to(F64)
        ev = ref_train.evaluate(before, sc.projector, sc.disparity, cfg, F64,
                                model.recorded[1] > 0.5, 2e-4)
        g_r = ev.grad
        d2 = ((g_p - g_r) ** 2).flatten()
        r2 = (g_r ** 2).flatten()
        top = torch.topk(d2, args.top).indices
        line = {"step": i + 1,
                "grad_gap": abs(float(g_p.norm()) - float(g_r.norm()))
                / float(g_r.norm()),
                "diff_rel": float(d2.sum().sqrt() / r2.sum().sqrt()),
                "diff_share_top": float(d2[top].sum() / d2.sum()),
                "ref_share_top": float(torch.topk(r2, args.top).values.sum()
                                       / r2.sum()),
                "ref_share_at_diff_top": float(r2[top].sum() / r2.sum())}
        # Runner-up margins of the windows' pixels around the worst pixels.
        b, hw = top // (H * W), top % (H * W)
        ys, xs = hw // W, hw % W
        margins, runner = [], []
        vol = zncc.volume(before[0].to(F64), sc.projector[0].to(F64), cfg)
        two = torch.topk(vol, 2, dim=-1).values
        w = torch.softmax(vol * float(cfg["softargmax_beta"]), dim=-1)
        w2 = torch.topk(w, 2, dim=-1).values[..., 1]
        k = int(cfg["kernel_size"]) // 2
        for bb, y, x in zip(b.tolist(), ys.tolist(), xs.tolist()):
            if bb != 0:
                continue
            y0, y1 = max(0, y - k), min(H, y + k + 1)
            x0, x1 = max(0, x - k), min(W, x + k + 1)
            m = (two[y0:y1, x0:x1, 0] - two[y0:y1, x0:x1, 1])
            margins.append(float(m.min()))
            runner.append(float(w2[y0:y1, x0:x1].max()))
        line["worst_pixels"] = list(zip(ys.tolist()[:5], xs.tolist()[:5]))
        line["min_top2_margin_near_worst"] = margins[:10]
        line["max_runnerup_weight_near_worst"] = runner[:10]
        print(json.dumps(line), flush=True)
        del vol, w, two
    return 0


if __name__ == "__main__":
    sys.exit(main())
