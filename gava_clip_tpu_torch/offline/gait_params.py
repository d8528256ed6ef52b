"""WHAM SMPL 3D joints -> clinical gait parameters (the port's own copy of
gava_clip_tpu/offline/gait_params.py; numpy and SciPy only, host side).

Butterworth filtering, heel-strike detection via vertical-foot minima with
left/right interleaving repair, step time / width / speed + CV + L-R
asymmetry + cadence, and margin of stability from the extrapolated center
of mass. It produces the metadata table that offline/preprocess.py turns
into NTE matrices and the support-memory bank. `save_metadata` writes
.xlsx when pandas and openpyxl import, else a .pkl of the same two tables,
which offline/preprocess.load_metadata reads too.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import signal

FPS = 30
MIN_HS_INTERVAL_S = 0.3   # minimum heel-strike interval (reference minThresh)

# SMPL joint indices used by the reference (get_smpl2_joint_names)
PELVIS, LHIP, RHIP, LFOOT, RFOOT = 0, 1, 2, 10, 11

GAIT_PARAM_NAMES = [
    "cadence", "speed", "meanstepwidth", "meansteptime",
    "diffstepwidth", "diffsteptime", "CVstepwidth", "CVsteptime",
    "mean_minMOS", "mean_meanMOS",
]


def butter_filter(x: np.ndarray, cutoff_hz: float, fps: int = FPS,
                  order: int = 2) -> np.ndarray:
    """Zero-phase Butterworth low-pass (reference :89-92 + filtfilt)."""
    b, a = signal.butter(order, cutoff_hz / (fps / 2))
    return signal.filtfilt(b, a, x, axis=0)


def detect_heel_strikes(foot_y: np.ndarray, fps: int = FPS) -> np.ndarray:
    """Heel strikes = local minima of the (filtered) vertical foot signal
    (reference :144-145)."""
    return signal.argrelextrema(foot_y, np.less)[0]


def interleave_heel_strikes(rh: np.ndarray, lh: np.ndarray,
                            r_y: np.ndarray, l_y: np.ndarray,
                            fps: int = FPS) -> Tuple[List[int], List[int]]:
    """Repair L/R heel-strike interleaving (reference :146-197): take the
    later-starting side as the reference sequence; between consecutive
    reference strikes keep the other side's lowest-foot minimum; drop
    reference strikes closer than the minimum interval."""
    if len(rh) == 0 or len(lh) == 0:
        return list(lh), list(rh)
    if rh[0] < lh[0]:
        ref_hs, interp_hs, interp_y = lh.copy(), rh.copy(), r_y
    else:
        ref_hs, interp_hs, interp_y = rh.copy(), lh.copy(), l_y

    kept_ref: List[int] = []
    kept_interp: List[int] = []
    last_rh = ref_hs[0]
    for i, r in enumerate(ref_hs):
        last_rh = r
        if i > 0 and r - ref_hs[i - 1] < MIN_HS_INTERVAL_S * fps:
            continue
        before = np.where(interp_hs < r)[0]
        cand = interp_hs[before]
        if len(cand) == 0:
            continue
        pick = cand[0] if len(cand) == 1 else cand[np.argmin(interp_y[cand])]
        kept_ref.append(int(r))
        kept_interp.append(int(pick))
        interp_hs = interp_hs[before[-1] + 1:]
    tail = interp_hs[interp_hs > last_rh]
    if len(tail) == 1:
        kept_interp.append(int(tail[0]))
    elif len(tail) > 1:
        kept_interp.append(int(tail[np.argmin(interp_y[tail])]))

    if rh[0] < lh[0]:
        return kept_ref, kept_interp     # (left, right)
    return kept_interp, kept_ref


@dataclass
class GaitResult:
    leglength: float
    params: Dict[str, float]


def compute_gait_parameters(joints3d: np.ndarray, fps: int = FPS) -> GaitResult:
    """(T, J>=12, 3) SMPL joints (y-up) -> gait parameters."""
    kin = np.asarray(joints3d, np.float64).copy()
    T = kin.shape[0]
    # ground the skeleton: subtract per-frame lowest joint height (:79-81)
    lowest = np.argmin(kin[:, :, 1], axis=1)
    kin[..., 1] -= kin[np.arange(T), lowest, 1][:, None]

    pelv = butter_filter(kin[:, PELVIS], 4.0, fps)
    rhip = butter_filter(kin[:, RHIP], 4.0, fps)
    lhip = butter_filter(kin[:, LHIP], 4.0, fps)
    rfoot = butter_filter(kin[:, RFOOT], 2.0, fps)
    lfoot = butter_filter(kin[:, LFOOT], 2.0, fps)

    # leg length = mean of max hip-foot distances (:122-127)
    rleg = np.linalg.norm(rhip - rfoot, axis=1).max()
    lleg = np.linalg.norm(lhip - lfoot, axis=1).max()
    leglength = 0.5 * rleg + 0.5 * lleg

    # extrapolated center of mass + margin of stability (:129-141)
    com = pelv
    omega = np.sqrt(9.81 / leglength)
    vcom = np.diff(com, axis=0)
    vcom = np.append(vcom, [vcom[-1]], axis=0)
    xcom = com + vcom / omega
    rmos0 = np.linalg.norm(xcom - rfoot, axis=-1)
    lmos0 = np.linalg.norm(xcom - lfoot, axis=-1)

    rh = detect_heel_strikes(rfoot[:, 1], fps)
    lh = detect_heel_strikes(lfoot[:, 1], fps)
    LHS, RHS = interleave_heel_strikes(rh, lh, rfoot[:, 1], lfoot[:, 1], fps)
    assert len(LHS) > 0 and len(RHS) > 0, "no heel strikes detected"

    lheels = [lfoot[i] for i in LHS]
    rheels = [rfoot[i] for i in RHS]

    r_time, l_time, r_width, l_width = [], [], [], []
    r_speed, l_speed = [], []
    min_rmos, mean_rmos, min_lmos, mean_lmos = [], [], [], []
    idx = -1
    for idx, (rhs, lhs) in enumerate(zip(RHS, LHS)):
        if rhs > lhs:
            r_time.append((rhs - lhs) / fps)
            r_width.append(float(np.linalg.norm(rheels[idx] - lheels[idx])))
            r_speed.append(r_width[-1] / r_time[-1])
            seg = rmos0[lhs:rhs]
            min_rmos.append(np.nanmin(np.abs(seg)))
            mean_rmos.append(np.nanmean(np.abs(seg)))
            if idx > 0:
                l_time.append((lhs - RHS[idx - 1]) / fps)
                l_width.append(float(np.linalg.norm(lheels[idx] - rheels[idx - 1])))
                l_speed.append(l_width[-1] / l_time[-1])
                seg = lmos0[RHS[idx - 1]:lhs]
                min_lmos.append(np.nanmin(np.abs(seg)))
                mean_lmos.append(np.nanmean(np.abs(seg)))
        else:
            l_time.append((lhs - rhs) / fps)
            l_width.append(float(np.linalg.norm(lheels[idx] - rheels[idx])))
            l_speed.append(l_width[-1] / l_time[-1])
            seg = lmos0[rhs:lhs]
            min_lmos.append(np.nanmin(np.abs(seg)))
            mean_lmos.append(np.nanmean(np.abs(seg)))
            if idx > 0:
                r_time.append((rhs - LHS[idx - 1]) / fps)
                r_width.append(float(np.linalg.norm(rheels[idx] - lheels[idx - 1])))
                r_speed.append(r_width[-1] / r_time[-1])
                seg = rmos0[LHS[idx - 1]:rhs]
                min_rmos.append(np.nanmin(np.abs(seg)))
                mean_rmos.append(np.nanmean(np.abs(seg)))

    # trailing unmatched strike (:346-361)
    if len(RHS) > len(LHS) and idx + 1 < len(RHS):
        rhs = RHS[idx + 1]
        r_time.append((rhs - LHS[idx]) / fps)
        r_width.append(float(np.linalg.norm(rheels[idx + 1] - lheels[idx])))
        r_speed.append(r_width[-1] / r_time[-1])
        seg = rmos0[LHS[idx]:rhs]
        min_rmos.append(np.nanmin(np.abs(seg)))
        mean_rmos.append(np.nanmean(np.abs(seg)))
    elif len(RHS) < len(LHS) and idx + 1 < len(LHS):
        lhs = LHS[idx + 1]
        l_time.append((lhs - RHS[idx]) / fps)
        l_width.append(float(np.linalg.norm(lheels[idx + 1] - rheels[idx])))
        l_speed.append(l_width[-1] / l_time[-1])
        seg = lmos0[RHS[idx]:lhs]
        min_lmos.append(np.nanmin(np.abs(seg)))
        mean_lmos.append(np.nanmean(np.abs(seg)))

    steptime = np.concatenate([r_time, l_time])
    stepwidth = np.concatenate([r_width, l_width])
    speed = float(np.mean(np.concatenate([r_speed, l_speed])))
    meansteptime = float(np.mean(steptime))
    meanstepwidth = float(np.mean(stepwidth))
    params = {
        "speed": speed,
        "meansteptime": meansteptime,
        "meanstepwidth": meanstepwidth,
        "CVsteptime": float(np.std(steptime) / meansteptime),
        "CVstepwidth": float(np.std(stepwidth) / meanstepwidth),
        "diffsteptime": float(abs(np.mean(r_time) - np.mean(l_time)))
        if r_time and l_time else float("nan"),
        "diffstepwidth": float(abs(np.mean(r_width) - np.mean(l_width)))
        if r_width and l_width else float("nan"),
        "cadence": 60.0 / meansteptime,
        "mean_minMOS": float(np.mean(np.concatenate([min_rmos, min_lmos]))),
        "mean_meanMOS": float(np.mean(np.concatenate([mean_rmos, mean_lmos]))),
    }
    return GaitResult(leglength=float(leglength), params=params)


def process_skeletons(skeleton_dict: Dict[str, Dict], fps: int = FPS) -> Dict[str, list]:
    """Map {vidname: {'joints3D', 'gait_score', 'diag'}} to the metadata table
    layout written by the reference (:424-441)."""
    result: Dict[str, list] = {k: [] for k in
                               ["vidname", "diag", "updrs", "leglength"]
                               + GAIT_PARAM_NAMES}
    for fn, data in sorted(skeleton_dict.items()):
        try:
            gr = compute_gait_parameters(np.asarray(data["joints3D"]), fps)
        except (AssertionError, ValueError) as e:
            print(f"Error in {fn}: {e}")
            continue
        result["vidname"].append(fn.split(".")[0])
        result["diag"].append(data.get("diag", -1))
        result["updrs"].append(data.get("gait_score", -1))
        result["leglength"].append(gr.leglength)
        for name in GAIT_PARAM_NAMES:
            result[name].append(gr.params[name])
    return result


def save_metadata(result: Dict[str, list], path: str, units: Optional[Dict[str, str]] = None):
    """Write the metadata table. Uses .xlsx (sheets part1/unit) when openpyxl
    is available — the reference format — otherwise a .pkl with the same
    two-table structure that offline/preprocess.py also accepts."""
    units = units or default_units()
    try:
        import pandas as pd
        with pd.ExcelWriter(path) as writer:
            pd.DataFrame(result).to_excel(writer, sheet_name="part1", index=False)
            pd.DataFrame([units]).to_excel(writer, sheet_name="unit", index=False)
        return path
    except (ImportError, ValueError, ModuleNotFoundError):
        import pickle
        alt = path.rsplit(".", 1)[0] + ".pkl"
        with open(alt, "wb") as f:
            pickle.dump({"part1": result, "unit": units}, f)
        return alt


def default_units() -> Dict[str, str]:
    return {
        "cadence": "steps per minute", "speed": "meters per second",
        "meanstepwidth": "meters", "meansteptime": "seconds",
        "diffstepwidth": "meters", "diffsteptime": "seconds",
        "CVstepwidth": "", "CVsteptime": "",
        "mean_minMOS": "meters", "mean_meanMOS": "meters",
    }
