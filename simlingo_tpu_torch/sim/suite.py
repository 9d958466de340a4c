"""MicroBench: the microsim's standing route suite + CLI.

Copy of `simlingo_tpu/sim/suite.py`. A Bench2Drive-style benchmark that
runs entirely in-repo: one route per scenario type (reference Bench2Drive
ships 220 routes over 44 scenario types; this suite covers the framework's
full scenario inventory once per type, in both clean and NPC-traffic
variants). Results are leaderboard-format JSON consumed by
eval/driving_score.py.

CLI (a model agent runs on the GPU unless `--device cpu`; the expert is
host numpy and ignores `--device`):
  # privileged expert, full suite, scores to stdout + JSON
  python -m simlingo_tpu_torch.sim.suite --agent expert --out results/micro.json

  # expert with dataset collection (the in-repo data-collection path):
  # one Town12_<route_id> directory a route under DIR
  python -m simlingo_tpu_torch.sim.suite --agent expert --collect DIR

  # trained model closed-loop (HF-layout or trained-SimLingo checkpoint)
  python -m simlingo_tpu_torch.sim.suite --agent model --checkpoint ckpt/ \
      --out results/model.json

  # a tiny random model, on the CPU (pipeline smoke)
  python -m simlingo_tpu_torch.sim.suite --agent tiny-model --device cpu \
      --routes micro_00_free --max-steps 3
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

MICROBENCH: List[Dict] = [
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_00_free"},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_01_traffic",
     "npcs": [{"at_s": 45.0, "lane": 0, "speed": 6.0},
              {"at_s": 90.0, "lane": 1, "speed": 7.0},
              {"at_s": 60.0, "lane": 2, "speed": 7.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_02_accident",
     "scenarios": [{"type": "Accident", "at_s": 110.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_03_accident_twoways", "town_kwargs":
         {"lanes_per_dir": 1},
     "scenarios": [{"type": "AccidentTwoWays", "at_s": 110.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_04_construction",
     "scenarios": [{"type": "ConstructionObstacle", "at_s": 110.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_05_construction_twoways",
     "town_kwargs": {"lanes_per_dir": 1},
     "scenarios": [{"type": "ConstructionObstacleTwoWays", "at_s": 110.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_06_parked",
     "scenarios": [{"type": "ParkedObstacle", "at_s": 100.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_07_parked_twoways",
     "town_kwargs": {"lanes_per_dir": 1},
     "scenarios": [{"type": "ParkedObstacleTwoWays", "at_s": 100.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_08_opens_door",
     "town_kwargs": {"lanes_per_dir": 1},
     "scenarios": [{"type": "VehicleOpensDoorTwoWays", "at_s": 100.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_09_hazard_side_lane",
     "scenarios": [{"type": "HazardAtSideLane", "at_s": 90.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_09b_hazard_side_lane_twoways",
     "town_kwargs": {"lanes_per_dir": 1},
     "scenarios": [{"type": "HazardAtSideLaneTwoWays", "at_s": 90.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_10_yield_emergency",
     "scenarios": [{"type": "YieldToEmergencyVehicle", "at_s": 60.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_11_ped_crossing",
     "scenarios": [{"type": "DynamicObjectCrossing", "at_s": 120.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_12_bicycle_flow",
     "scenarios": [{"type": "CrossingBicycleFlow", "at_s": 130.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_13_blocked_intersection",
     "scenarios": [{"type": "BlockedIntersection", "at_s": 120.0}]},
    {"town": "curved", "start_s": 5.0, "end_s": 240.0,
     "route_id": "micro_14_invading_turn",
     "scenarios": [{"type": "InvadingTurn", "at_s": 100.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 290.0,
     "route_id": "micro_15_signalized_junction"},
    {"town": "crossing", "start_s": 5.0, "end_s": 290.0,
     "route_id": "micro_16_stop_sign",
     "town_kwargs": {"lights": False, "stop_sign": True}},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "left",
     "route_id": "micro_17_junction_left"},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "right",
     "route_id": "micro_18_junction_right"},
    {"town": "grid", "town_kwargs": {"blocks_x": 2, "blocks_y": 2},
     "route_id": "micro_19_grid_multiturn",
     "via": [[10.0, -1.75], [121.75, 60.0], [180.0, 118.25]],
     "scenarios": [{"type": "ParkedObstacle", "at_s": 60.0}],
     "npcs": [{"at_s": 30.0, "lane": 8, "speed": 6.0},
              {"at_s": 100.0, "lane": 3, "speed": 6.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_20_red_runner",
     "scenarios": [{"type": "OppositeVehicleRunningRedLight",
                    "at_s": 120.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_21_highway_cut_in",
     "scenarios": [{"type": "HighwayCutIn", "at_s": 60.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_22_static_cut_in",
     "scenarios": [{"type": "StaticCutIn", "at_s": 80.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "left",
     "route_id": "micro_23_signalized_left_turn",
     "scenarios": [{"type": "SignalizedJunctionLeftTurn", "at_s": 138.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_24_parking_crossing_ped",
     "scenarios": [{"type": "ParkingCrossingPedestrian", "at_s": 110.0}]},
    # -- Merging ability: actor flows, ramps, sequential changes ----------
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "right",
     "town_kwargs": {"lights": False},
     "route_id": "micro_25_enter_actor_flow",
     "scenarios": [{"type": "EnterActorFlow", "at_s": 140.0}]},
    {"town": "highway", "town_kwargs": {"ramp": "exit"},
     "via": [[5.0, -1.75], [170.0, -5.25], [398.0, -14.6]],
     "route_id": "micro_26_highway_exit",
     "scenarios": [{"type": "HighwayExit", "at_s": 250.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "left",
     "town_kwargs": {"lights": False},
     "route_id": "micro_27_interurban_flow",
     "scenarios": [{"type": "InterurbanActorFlow", "at_s": 140.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "left",
     "town_kwargs": {"lights": False},
     "route_id": "micro_28_interurban_advanced",
     "scenarios": [{"type": "InterurbanAdvancedActorFlow",
                    "at_s": 140.0}]},
    {"town": "highway", "town_kwargs": {"ramp": "entry"},
     "via": [[183.0, -14.4], [350.0, -5.25]],
     "route_id": "micro_29_merge_slow_traffic",
     "scenarios": [{"type": "MergerIntoSlowTraffic", "at_s": 75.0}]},
    {"town": "highway", "town_kwargs": {"ramp": "entry"},
     "via": [[183.0, -14.4], [350.0, -5.25]],
     "route_id": "micro_30_merge_slow_traffic_v2",
     "scenarios": [{"type": "MergerIntoSlowTrafficV2", "at_s": 75.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "left",
     "town_kwargs": {"lights": False},
     "route_id": "micro_31_nonsig_left_turn",
     "scenarios": [{"type": "NonSignalizedJunctionLeftTurn",
                    "at_s": 140.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "right",
     "town_kwargs": {"lights": False},
     "route_id": "micro_32_nonsig_right_turn",
     "scenarios": [{"type": "NonSignalizedJunctionRightTurn",
                    "at_s": 140.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "left",
     "town_kwargs": {"lights": False},
     "route_id": "micro_33_nonsig_left_enter_flow",
     "scenarios": [{"type": "NonSignalizedJunctionLeftTurnEnterFlow",
                    "at_s": 140.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "right",
     "route_id": "micro_34_sig_right_turn",
     "scenarios": [{"type": "SignalizedJunctionRightTurn",
                    "at_s": 140.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "left",
     "route_id": "micro_35_sig_left_enter_flow",
     "scenarios": [{"type": "SignalizedJunctionLeftTurnEnterFlow",
                    "at_s": 140.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 160.0, "ego_lane": 1,
     "town_kwargs": {"parking_lane": True}, "parking_exit": True,
     "route_id": "micro_36_parking_exit",
     "scenarios": [{"type": "ParkingExit", "at_s": 5.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0, "ego_lane": 2,
     "town_kwargs": {"lanes_per_dir": 3},
     "route_id": "micro_37_sequential_lane_change",
     "scenarios": [{"type": "SequentialLaneChange", "at_s": 110.0}]},
    # -- Emergency_Brake ability -------------------------------------------
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_38_hard_brake",
     "scenarios": [{"type": "HardBreakRoute", "at_s": 60.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 290.0,
     "town_kwargs": {"lights": False},
     "route_id": "micro_39_opposite_priority",
     "scenarios": [{"type": "OppositeVehicleTakingPriority",
                    "at_s": 145.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0, "ego_lane": 1,
     "town_kwargs": {"parking_lane": True},
     "route_id": "micro_40_parking_cut_in",
     "scenarios": [{"type": "ParkingCutIn", "at_s": 100.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 290.0,
     "route_id": "micro_41_pedestrian_crossing",
     "scenarios": [{"type": "PedestrianCrossing", "at_s": 140.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "right",
     "route_id": "micro_42_vehicle_turning_route",
     "scenarios": [{"type": "VehicleTurningRoute", "at_s": 160.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "left",
     "route_id": "micro_43_vehicle_turning_ped",
     "scenarios": [{"type": "VehicleTurningRoutePedestrian",
                    "at_s": 160.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 220.0,
     "route_id": "micro_44_control_loss",
     "scenarios": [{"type": "ControlLoss", "at_s": 80.0}]},
    # -- Traffic_Signs ability ----------------------------------------------
    {"town": "crossing", "start_s": 5.0, "end_s": 290.0,
     "town_kwargs": {"t_junction": True},
     "route_id": "micro_45_t_junction",
     "scenarios": [{"type": "T_Junction", "at_s": 145.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "right",
     "town_kwargs": {"lights": False},
     "route_id": "micro_46_vanilla_nonsig_turn",
     "scenarios": [{"type": "VanillaNonSignalizedTurn", "at_s": 140.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "right",
     "route_id": "micro_47_vanilla_sig_green",
     "scenarios": [{"type": "VanillaSignalizedTurnEncounterGreenLight",
                    "at_s": 140.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "left",
     "route_id": "micro_48_vanilla_sig_red",
     "scenarios": [{"type": "VanillaSignalizedTurnEncounterRedLight",
                    "at_s": 140.0}]},
    {"town": "crossing", "start_s": 5.0, "end_s": 260.0, "turn": "right",
     "town_kwargs": {"lights": False, "stop_sign": True},
     "route_id": "micro_49_vanilla_stop_turn",
     "scenarios": [{"type": "VanillaNonSignalizedTurnEncounterStopsign",
                    "at_s": 140.0}]},
]


def microbench220() -> List[Dict]:
    """The Bench2Drive-protocol suite: 220 routes = 44 scenario types x 5
    deterministic variants (reference bench2drive220.xml: 220 short
    routes, one scenario each, all towns; README.md:207).

    Each variant perturbs the type's proven MicroBench base spec along
    axes that change the closed-loop dynamics without breaking the
    scenario's geometry: scenario arc position (where the town allows),
    ego start speed (shifts every flow/trigger encounter timing), world
    seed, and background traffic on multi-lane straight towns.
    """
    by_type: Dict[str, Dict] = {}
    for spec in MICROBENCH:
        if spec.get("scenarios"):
            by_type.setdefault(spec["scenarios"][0]["type"], spec)
    out: List[Dict] = []
    for name in sorted(by_type):
        base = by_type[name]
        junction_town = base.get("town") in ("crossing", "grid")
        for k in range(5):
            spec = json.loads(json.dumps(base))     # deep copy
            sc = spec["scenarios"][0]
            if not junction_town and name not in ("ParkingExit",):
                # junction scenarios are anchored to the junction; only
                # straight/highway placements can slide along the road
                sc["at_s"] = float(sc["at_s"]) + (k - 2) * 6.0
            spec["start_speed"] = [0.0, 3.0, 0.0, 5.0, 1.5][k]
            spec["seed"] = k
            if (spec.get("town") == "straight" and k in (1, 3)
                    and spec.get("town_kwargs", {}).get(
                        "lanes_per_dir", 2) >= 2
                    and not spec.get("parking_exit")):
                # background vehicle on the opposite carriageway
                n_fwd = spec.get("town_kwargs", {}).get("lanes_per_dir", 2)
                spec.setdefault("npcs", []).append(
                    {"at_s": 160.0, "lane": n_fwd, "speed": 6.0})
            spec["route_id"] = f"b2d_{name}_{k}"
            out.append(spec)
    return out


SUITES = {"micro": lambda: MICROBENCH, "b2d220": microbench220}


def load_model_agent(checkpoint: Optional[str], tiny: bool = False,
                     device="cuda", model_cfg=None):
    """Build a LingoAgent from a checkpoint (`core/checkpoint.
    load_hf_checkpoint`: the model of `model_cfg`, by default
    presets.internvl2_1b(), and the default AgentConfig, in bf16), or a
    tiny random model for pipeline smoke tests
    (its weights drawn on the CPU, so that they do not depend on the
    device; fp32 on the CPU, bf16 on the GPU, where the kernels take
    bf16)."""
    import torch
    from simlingo_tpu_torch.agent.agent import LingoAgent
    from simlingo_tpu_torch.agent.config import AgentConfig
    from simlingo_tpu_torch.core.device import resolve_device
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.models import simlingo

    dev = resolve_device(device)
    tok = SimLingoTokenizer()
    if tiny or checkpoint is None:
        from simlingo_tpu_torch.models.qwen2 import Qwen2Config
        from simlingo_tpu_torch.models.simlingo import SimLingoConfig
        from simlingo_tpu_torch.models.vit import ViTConfig
        cfg = SimLingoConfig(
            vit=ViTConfig(hidden_size=64, num_layers=2, num_heads=4,
                          intermediate_size=128, image_size=448,
                          patch_size=56, projector_out=64),
            llm=Qwen2Config.tiny(vocab_size=tok.tk.vocab_size + 8),
            img_context_token_id=tok.img_context_id,
            remat_vision=False, remat_llm=False)
        params = simlingo.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        return LingoAgent(params, cfg, AgentConfig(use_cot=False,
                                                   initial_frames_delay=0),
                          tokenizer=tok, max_prompt_len=128,
                          compute_dtype=(torch.float32 if dev.type == "cpu"
                                         else torch.bfloat16),
                          device=dev)
    from simlingo_tpu_torch.core import checkpoint as ckpt
    from simlingo_tpu_torch.core.presets import internvl2_1b
    cfg = model_cfg if model_cfg is not None else internvl2_1b()
    params = ckpt.load_hf_checkpoint(checkpoint, cfg)
    return LingoAgent(params, cfg, AgentConfig(), tokenizer=tok, device=dev)


def main(argv=None) -> Dict:
    from simlingo_tpu_torch.eval.driving_score import merge_route_results
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    from simlingo_tpu_torch.sim.runner import (expert_factory, model_factory,
                                               run_routes)

    ap = argparse.ArgumentParser(description="MicroBench closed-loop suite")
    ap.add_argument("--agent", choices=("expert", "model", "tiny-model"),
                    default="expert")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint for --agent model (load_hf_checkpoint)")
    ap.add_argument("--collect", default=None,
                    help="dataset root: save expert sensor data per route")
    ap.add_argument("--out", default=None, help="result JSON path")
    ap.add_argument("--suite", choices=sorted(SUITES), default="micro",
                    help="micro: 51 routes, one per scenario type; "
                         "b2d220: the Bench2Drive protocol, 44 types x 5 "
                         "variants")
    ap.add_argument("--routes", default=None,
                    help="comma-separated route_id filter")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--record", default=None,
                    help="dir for per-route replay records "
                         "(scenario_logger render_replay_frames / "
                         "make_infraction_gifs input)")
    ap.add_argument("--device", default="cuda",
                    help="a model agent's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    specs = SUITES[args.suite]()
    if args.routes:
        wanted = set(args.routes.split(","))
        specs = [s for s in specs if s["route_id"] in wanted
                 or any(w in s["route_id"] for w in wanted)]
    out_path = args.out or "microbench_results.json"
    if args.agent == "expert" and args.collect:
        # collection: one dataset dir per route, named for the training
        # pipeline's layout (data/simlingo/*/*/routes_training/Town*) --
        # per-spec factories so each route gets its own directory
        records = []
        for i, spec in enumerate(specs):
            factory = expert_factory(
                save_root=args.collect,
                dir_name_fmt=f"Town12_{spec['route_id']}")
            records.extend(run_routes(
                [spec], factory, seed=i, max_steps=args.max_steps,
                record_dir=args.record)["_checkpoint"]["records"])
        checkpoint = {"_checkpoint": {"records": records}}
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(checkpoint, f, indent=1)
    elif args.agent == "expert":
        checkpoint = run_routes(specs, expert_factory(), out_path=out_path,
                                max_steps=args.max_steps,
                                record_dir=args.record)
    else:
        agent = load_model_agent(args.checkpoint,
                                 tiny=args.agent == "tiny-model",
                                 device=args.device)
        checkpoint = run_routes(specs, model_factory(agent), out_path=out_path,
                                max_steps=args.max_steps,
                                record_dir=args.record)
        agent.close()
        # the ticks that ran the model (the first initial_frames_delay
        # settle), and the hand kernels they launched (none on the CPU)
        print(f"agent: {len(agent.latencies)} inference ticks of "
              f"{agent.step_count} on {args.device}; hand-kernel launches "
              f"flash_attn_fwd {FA.flash_attn_fwd.launches} "
              f"int8_matmul {QM.int8_matmul.launches}")
    records = checkpoint["_checkpoint"]["records"]
    for r in records:
        inf = {k: len(v) for k, v in r["infractions"].items() if v}
        print(f"{r['route_id']:>32}: {r['status']:<40} "
              f"DS={r['scores']['score_composed']:6.1f} "
              f"RC={r['scores']['score_route']:6.1f} {inf}")
    summary = merge_route_results([out_path])
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
