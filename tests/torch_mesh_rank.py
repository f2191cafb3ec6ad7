"""One rank of a meshed run of the port, for the mesh tests.

``python tests/torch_mesh_rank.py RANK WORLD RENDEZVOUS SPEC`` joins a
gloo world of ``WORLD`` ranks at the ``file://`` rendezvous ``RENDEZVOUS``
and runs the scenarios of the JSON file ``SPEC`` in order, every rank the
same ones (their collectives pair up). A scenario is either ``argv``, a
command line of ``repro_torch.launch.train_fleet`` (``--mesh`` in it), or
``lib``, a library run of ``train_fleet_scan`` / ``train_fleet_reference``
on a whole fleet and inputs read from an ``.npz`` (``fleet_from_numpy``'s
tree under ``fleet/...`` keys, ``traces``, optional ``gumbel``), placed on
a (pod, data) mesh. After each, every rank saves the whole fleet
(``training.checkpoint.save``, gathered, written by rank 0) to
``OUT/<name>/``, and rank 0 writes the history (``hist.npz``) and
``info.json``: the per-rank fleet bytes, this rank's agents, and the
kernel and collective counts of rank 0's run. ``mesh_factory`` records
what the mesh builders give at this world size.

Each rank prints a flushed ``MESH-PROGRESS start NAME`` / ``MESH-PROGRESS
done NAME`` line around every scenario (``mesh_factory`` included), so
that the spawning test can tell a slow world from a stuck one and say
where each rank was. The collectives time out after ``SPEC``'s
``collective_timeout_s`` (120 s by default): a rank stuck in one raises
instead of hanging.

The ranks run one intra-op thread each; ``SPEC`` may set ``device``
(``cpu``, the default, or ``cuda``: gloo collectives on CUDA tensors) and
``backend`` (``gloo``, the default, or ``nccl``: rank r on card r, as
torchrun's ``LOCAL_RANK`` places it). A library run of the graph driver
adds to ``info.json`` the sizes of the process groups it warmed and its
host graph launches.
"""
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core import fleet as tfleet
from repro_torch.distributed.sharding import COLLECTIVES
from repro_torch.fl.transport import TransportConfig
from repro_torch.kernels.delta_codec import delta_codec
from repro_torch.kernels.diversity import diversity_insert
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train_fleet as train_cli
from repro_torch.training import checkpoint as ckpt


def _nested(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def mesh_factory():
    """The mesh builders at this world size: shapes, and the errors."""
    world = dist.get_world_size()
    out = {"fleet_2": mesh_mod.make_fleet_mesh(world, 2, "cpu").shape,
           "fleet_3": mesh_mod.make_fleet_mesh(world, 3, "cpu").shape,
           "debug": mesh_mod.make_debug_mesh(world, 1, "cpu").shape}
    for name, fn in (("production", lambda: mesh_mod.make_production_mesh(
            device_type="cpu")), ("wrong_size", lambda: mesh_mod.make_fleet_mesh(
                2 * world, 2, "cpu"))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    if world == 8:
        # agents over ("pod", "data") of a (2, 2, 2) mesh: a group of two
        # axes beside a third (the production multi-pod layout, scaled down)
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        place = tfleet.fleet_placement(mesh, 4, 2)
        mine = torch.tensor([float(dist.get_rank())])
        total = torch.tensor([float(place.agents.start)])
        dist.all_reduce(mine, group=place.agent_group)
        dist.all_reduce(total, group=place.agent_group)
        out["pod_data_model"] = dict(
            agents=[place.agents.start, place.agents.stop],
            group=dist.get_process_group_ranks(place.agent_group),
            rank_sum=mine.item(), start_sum=total.item())
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in out.items()}


def run_lib(lib, device):
    """A library run: the whole fleet and inputs from ``lib["npz"]``.
    Returns (fleet, history, what the graph driver reports: the sizes of
    the process groups it warmed, its host graph launches)."""
    data = np.load(lib["npz"])
    cfg = FCPOConfig(fl_every=lib.get("fl_every", 1))
    tree = _nested({k[len("fleet/"):]: data[k] for k in data.files
                    if k.startswith("fleet/")})
    tree["episode"] = 0
    fleet = tfleet.fleet_from_numpy(cfg, tree, device=device)
    mesh = mesh_mod.make_fleet_mesh(dist.get_world_size(),
                                    fleet.n_pods, device)
    gumbel = (torch.tensor(data["gumbel"]) if "gumbel" in data.files
              else None)
    kw = dict(mesh=mesh, gumbel=gumbel,
              transport=TransportConfig(codec=lib.get("codec", "float32")),
              straggler_prob=lib.get("straggler_prob", 0.0),
              seed=lib.get("seed", 0))
    traces = torch.tensor(data["traces"])
    if lib.get("driver", "scan") != "scan":
        return (*tfleet.train_fleet_reference(cfg, fleet, traces, **kw), {})
    scan = tfleet.FleetScan(cfg, fleet, traces, **kw)
    fleet, hist = scan.run()
    return fleet, hist, {"warmed": scan.warmed,
                         "graph_launches": scan.graph_launches}


def progress(what, name):
    """One marker line for the spawning test, flushed at once."""
    print(f"MESH-PROGRESS {what} {name}", flush=True)


def main(rank, world, rendezvous, spec_path):
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    device = spec.get("device", "cpu")
    backend = spec.get("backend", "gloo")
    if backend == "nccl":
        # one card a rank, as torchrun's LOCAL_RANK gives it
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
    timeout = datetime.timedelta(
        seconds=spec.get("collective_timeout_s", 120))
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world, timeout=timeout)
    try:
        if spec.get("mesh_factory"):
            progress("start", "mesh_factory")
            info = mesh_factory()
            if rank == 0:
                with open(os.path.join(spec["out"], "mesh_factory.json"),
                          "w") as f:
                    json.dump(info, f)
            progress("done", "mesh_factory")
        for sc in spec["scenarios"]:
            progress("start", sc["name"])
            counted = (diversity_insert, delta_codec, COLLECTIVES)
            for fn in counted:
                fn.launches = 0
            if "argv" in sc:
                fleet, hist = train_cli.main(sc["argv"])
                driver = {}
            else:
                fleet, hist, driver = run_lib(sc["lib"], device)
            counts = [fn.launches for fn in counted]
            out = os.path.join(spec["out"], sc["name"])
            per = tfleet.fleet_device_bytes(fleet)
            ckpt.save(out, 0, fleet)
            if rank == 0:
                np.savez(os.path.join(out, "hist.npz"), **hist)
                place = fleet.placement
                with open(os.path.join(out, "info.json"), "w") as f:
                    json.dump({"device_bytes": per,
                               "agents": [place.agents.start,
                                          place.agents.stop],
                               "agents_split": place.agents_split,
                               "pod_group_is_world":
                                   place.pod_group is dist.group.WORLD,
                               "k1": counts[0], "k2": counts[1],
                               "collectives": counts[2], **driver}, f)
            dist.barrier()
            progress("done", sc["name"])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
