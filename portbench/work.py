"""The FP32 operations a frame's search needs, from the configuration's
sizes alone (never from the program's defaults: the configuration file
states every size counted here).

Counted: the correspondence searches (9 operations per scene-model point
pair: 3 sub, 3 mul, 2 add, a compare) and the Gauss-Newton passes (~105
operations per particle and scene point: the gates, the Jacobian, the
residual, the 30 products of the normal equations and their sums). Not
counted: scoring, splats, the prescreen's scoring pass and the finisher,
so the count is a lower bound on the work and the share it gives of the
card's peak cannot pass 100%. The count does not depend on which kernel
does the work.

A tracked frame: the in-scan refines (one per `icp_every` iterations, each
`icp_iters_inner` searches of the particle swarm's `icp_scene_subset` x
`icp_model_subset` points), the explorer seeds' three refines, the
fine-tier polish of the candidates (`icp.iters` full-cloud searches) and
the candidates' full-cloud support search. An init frame: the prescreen's
support re-rank, the init scan at `reinit_particles` over twice the
iterations with `reinit_icp_iters_inner` searches of
`reinit_icp_model_subset` model points, no explorers, and the polish."""
from __future__ import annotations


def frame_work(est: dict, mode: str) -> dict:
    """{'pairs', 'gn', 'ops'} of one object's frame in `mode` ('track' or
    'init'), from the configuration's `estimator` sizes."""
    p, ic, sc, tr = est["pso"], est["icp"], est["score"], est["tracker"]
    ns, nm = est["scene_points"], est["model_points"]
    ks = min(p["icp_scene_subset"], ns)
    gn_scan = 1 if ic["fused_gn"] else ic["gn_reps"]
    use_cov = sc["scene_cov_weight"] > 0
    pairs = gn = 0.0
    if mode == "track":
        P, iters = p["particles"], p["iters"]
        inner, km = p["icp_iters_inner"], min(p["icp_model_subset"], nm)
        n_explore = int(round(P * p["explore_frac"]))
    elif mode == "init":
        P, iters = tr["reinit_particles"], 2 * p["iters"]
        inner, km = tr["reinit_icp_iters_inner"], min(tr["reinit_icp_model_subset"], nm)
        n_explore = 0
        if use_cov and tr["prescreen_support"] > 0 and tr["reinit_prescreen"] > P:
            n_sup = min(max(tr["prescreen_support"], 2 * (P // 2)), tr["reinit_prescreen"])
            pairs += n_sup * ks * km
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if p["icp_every"] > 0:
        refines = (iters + p["icp_every"] - 1) // p["icp_every"]
        pairs += refines * inner * P * ks * km
        gn += refines * inner * gn_scan * P * ks
    if n_explore and P > n_explore:
        pairs += 3 * inner * n_explore * ks * km
        gn += 3 * inner * gn_scan * n_explore * ks
    n_cand = min(p["polish_top_k"], P - 1) + 1 + (1 if n_explore else 0)
    if p["slide_proposals"] > 1:
        n_cand += 2 * (p["slide_proposals"] // 2)
    pairs += ic["iters"] * n_cand * ns * nm
    gn += ic["iters"] * ic["gn_reps"] * n_cand * ns
    if use_cov:
        pairs += n_cand * ns * nm
    return {"pairs": pairs, "gn": gn, "ops": 9.0 * pairs + 105.0 * gn}


def refine_equivalents(est: dict) -> float:
    """A tracked frame's correspondence pairs over those of one 30-iteration
    full-cloud refine."""
    return frame_work(est, "track")["pairs"] / (
        30.0 * est["scene_points"] * est["model_points"])
