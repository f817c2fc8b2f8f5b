"""CLI driver: subcommand dispatch + train/test/predict execution.

Port of ``deeplearning4j_tpu/cli/driver.py``: the same subcommands, flags,
properties and messages, plus ``--device`` (default: the CUDA card; with
no card it raises, and ``cpu`` runs the plain PyTorch paths). ``train``
prints one line per epoch with the last batch's score and, when the
configuration pretrains, each pretrained layer's score per batch (the
RBM's reconstruction error). ``-runtime mesh`` trains through a
``ParallelWrapper`` over the world ``torchrun``'s environment describes
(``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``), or a world of
one; ``-runtime multihost`` first joins the ranks through
``cluster.initialize_distributed`` (``--coordinator``, ``--num-processes``,
``--process-id`` or the ``runtime.*`` properties). Every rank trains on
the same data; rank 0 alone writes the model zip and the checkpoints.

Reference: ``cli/driver/CommandLineInterfaceDriver.java:60`` (main
dispatches subcommands), ``cli/subcommands/Train.java:128`` (execute():
load properties → build record reader → fromJson model conf → fit → save),
``Test.java``, ``Predict.java``. The reference's properties-file keys
(``input.format`` etc. at Train.java:68-75) are mirrored with the same
flag-overrides-properties precedence.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np


def load_properties(path: str) -> Dict[str, str]:
    """Java-style properties: key=value lines, '#'/'!' comments."""
    props: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] in "#!":
                continue
            if "=" in line:
                k, _, v = line.partition("=")
            elif ":" in line:
                k, _, v = line.partition(":")
            else:
                continue
            props[k.strip()] = v.strip()
    return props


def _build_reader(input_path: str, input_format: str, zero_based: bool,
                  num_features: Optional[int]):
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader, SVMLightRecordReader)

    if input_format == "csv":
        return CSVRecordReader(input_path)
    if input_format == "svmlight":
        if num_features is None:
            # infer from the file's max index; pass --num-features /
            # input.num.features to pin the width across train and test
            # files with different trailing sparsity
            max_idx = 0
            with open(input_path) as f:
                for line in f:
                    for tok in line.split()[1:]:
                        if ":" in tok:
                            max_idx = max(max_idx, int(tok.split(":")[0]))
            num_features = max_idx + 1 if zero_based else max_idx
        return SVMLightRecordReader(input_path, num_features=num_features,
                                    zero_based=zero_based)
    raise ValueError(f"unknown input format: {input_format}")


def _build_iterator(args, props: Dict[str, str]):
    from deeplearning4j_tpu_torch.datasets.records import (
        RecordReaderDataSetIterator)

    input_format = args.input_format or props.get("input.format", "csv")
    batch_size = (args.batch_size if args.batch_size is not None
                  else int(props.get("batch.size", "32")))
    label_index = (args.label_index if args.label_index is not None
                   else int(props.get("input.label.index", "-1")))
    num_classes = (args.num_classes if args.num_classes is not None
                   else (int(props["input.num.classes"])
                         if "input.num.classes" in props else None))
    num_features = (args.num_features if args.num_features is not None
                    else (int(props["input.num.features"])
                          if "input.num.features" in props else None))
    zero_based = args.zero_based or (
        props.get("input.zero.based", "false").lower() == "true")
    regression = args.regression or (
        props.get("input.regression", "false").lower() == "true")
    reader = _build_reader(args.input, input_format, zero_based,
                           num_features)
    return RecordReaderDataSetIterator(
        reader, batch_size, label_index=label_index,
        num_classes=num_classes, regression=regression)


def _full_dataset(it, input_path: str):
    """Drain an iterator into one DataSet (for eval/predict)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    batches = []
    it.reset()
    while it.has_next():
        batches.append(it.next())
    if not batches:
        raise SystemExit(f"no records in input file: {input_path}")
    return DataSet.merge(batches)


def _make_runtime(runtime: str, net, args, props: Dict[str, str]):
    """Select the execution runtime (reference: ``-runtime local|hadoop|
    spark``, cli/subcommands/Train.java:75,128, re-expressed as local |
    mesh | multihost).

    - ``local``     — fit on ``--device``.
    - ``mesh``      — a data-parallel ``ParallelWrapper`` over the world
                       ``torchrun``'s environment describes (joined here
                       when it is not up yet), or a world of one;
                       ``--mesh-devices``/``runtime.mesh.devices`` n
                       trains over ranks ``[0, n)`` (the reference's first
                       n devices); the other ranks park, and n above the
                       world's size raises.
    - ``multihost`` — join the world first
                       (``cluster.initialize_distributed``: coordinator and
                       rank from flags or ``runtime.*`` properties), then
                       data-parallel over it.
    """
    if runtime == "local":
        return net
    import os

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.cluster import (
        ClusterConfig, initialize_distributed)
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    if runtime == "multihost":
        coord = args.coordinator or props.get("runtime.coordinator")
        nproc = (args.num_processes
                 if args.num_processes is not None
                 else int(props.get("runtime.num.processes", "1")))
        pid = (args.process_id if args.process_id is not None
               else int(props.get("runtime.process.id", "0")))
        if nproc > 1 and not coord:
            raise SystemExit(
                "-runtime multihost with --num-processes > 1 requires "
                "--coordinator host:port (or the runtime.coordinator "
                "property) — refusing to silently train single-process")
        initialize_distributed(ClusterConfig(
            coordinator_address=coord, num_processes=nproc, process_id=pid),
            device=net.device)
    elif runtime != "mesh":
        raise SystemExit(f"unknown -runtime {runtime!r} "
                         "(one of: local, mesh, multihost)")
    elif (not dist.is_initialized()
          and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        initialize_distributed(ClusterConfig(
            coordinator_address=(f"{os.environ['MASTER_ADDR']}:"
                                 f"{os.environ['MASTER_PORT']}"),
            num_processes=int(os.environ["WORLD_SIZE"]),
            process_id=int(os.environ["RANK"])), device=net.device)
    n_dev = args.mesh_devices or (
        int(props["runtime.mesh.devices"])
        if "runtime.mesh.devices" in props else None)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_dev is not None and n_dev > world:
        raise SystemExit(
            f"--mesh-devices {n_dev} exceeds the world's {world} rank(s): "
            "each rank is one process on one device")
    mesh = build_mesh(MeshSpec(data=n_dev or -1), device=net.device,
                      ranks=None if n_dev is None else range(n_dev))
    return ParallelWrapper(net, mesh=mesh)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _net_from_document(doc: str, device=None):
    """Build the right network from a config document, discriminating on
    DOCUMENT SHAPE (not parse failure): a reference-exported Jackson
    MultiLayer doc has a top-level "confs" list, a reference
    ComputationGraph doc has "vertices" + "networkInputs"
    (ComputationGraphConfiguration.java:59-70), our native graph format
    self-identifies via its "format" tag, anything else is a native
    MultiLayer doc. Non-JSON input parses as YAML (both reference
    ``toYaml()`` flavors and our own block YAML)."""
    import json

    from deeplearning4j_tpu_torch.nn.conf.graph import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    try:
        parsed = json.loads(doc)
    except json.JSONDecodeError:
        from deeplearning4j_tpu_torch.utils.yamlio import load

        parsed = load(doc)
    if not isinstance(parsed, dict):
        raise SystemExit("model document is not a mapping")
    from deeplearning4j_tpu_torch.nn.conf.compat import (
        _graph_from_reference_dict, _mln_from_reference_dict)

    if "confs" in parsed:
        return MultiLayerNetwork(_mln_from_reference_dict(parsed),
                                 device=device).init()
    if "vertices" in parsed and "networkInputs" in parsed:
        return ComputationGraph(_graph_from_reference_dict(parsed),
                                device=device).init()
    if str(parsed.get("format", "")).endswith(
            "ComputationGraphConfiguration"):
        return ComputationGraph(
            ComputationGraphConfiguration.from_dict(parsed),
            device=device).init()
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(parsed),
                             device=device).init()


def cmd_train(args) -> int:
    from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

    props = load_properties(args.conf) if args.conf else {}
    with open(args.model) as f:
        doc = f.read()
    net = _net_from_document(doc, args.device)
    ckpt_dir = args.checkpoint_dir or props.get("checkpoint.dir")
    start_epoch = 0
    if args.resume and not ckpt_dir:
        raise SystemExit(
            "--resume requires --checkpoint-dir (or the checkpoint.dir "
            "property) — refusing to silently retrain from scratch")
    if ckpt_dir and args.resume:
        from deeplearning4j_tpu_torch.utils.checkpoint import (
            latest_step, restore_network)

        step = latest_step(ckpt_dir)
        if step is not None:
            restore_network(ckpt_dir, net, step=step)
            start_epoch = step
            print(f"resumed from checkpoint epoch {step} in {ckpt_dir}")
        else:
            print(f"no checkpoint in {ckpt_dir}; training from scratch")
    epochs_requested = (args.epochs if args.epochs is not None
                        else int(props.get("epochs", "1")))
    if start_epoch > epochs_requested:
        # an iteration-keyed directory (e.g. CheckpointIterationListener's)
        # would silently skip ALL training if treated as an epoch count
        raise SystemExit(
            f"checkpoint step {start_epoch} exceeds --epochs "
            f"{epochs_requested}: this directory is not epoch-keyed "
            "(cli train writes one checkpoint per epoch; iteration-keyed "
            "dirs from CheckpointIterationListener resume via "
            "utils.checkpoint.restore_network instead)")
    import torch.distributed as dist

    runtime = args.runtime or props.get("runtime", "local")
    owns_world = runtime != "local" and not dist.is_initialized()
    runner = _make_runtime(runtime, net, args, props)
    it = _build_iterator(args, props)
    epochs = epochs_requested
    writer = _rank() == 0  # over a world, rank 0 alone writes files
    for epoch in range(start_epoch, epochs):
        it.reset()
        runner.fit(it)
        _report_epoch(net, epoch + 1, epochs)
        if ckpt_dir and writer:
            from deeplearning4j_tpu_torch.utils.checkpoint import save_network

            # epoch-keyed checkpoint: kill the process anywhere and
            # --resume picks up after the last completed epoch
            save_network(ckpt_dir, net, step=epoch + 1)
    if writer:
        ModelSerializer.write_model(net, args.output)
    if runner is not net and dist.get_world_size() > 1:
        dist.barrier()  # the zip is on disk before any rank returns
    if owns_world:  # joined here: left here
        from deeplearning4j_tpu_torch.parallel.mesh import leave_world

        leave_world()
    ran = max(0, epochs - start_epoch)
    suffix = f" ({start_epoch} resumed)" if start_epoch else ""
    print(f"model trained ({ran} epoch(s){suffix}, runtime={runtime}) "
          f"and saved to {args.output}")
    return 0


def _report_epoch(net, epoch: int, epochs: int) -> None:
    """One line per epoch: the last batch's score (one device read) and
    each pretrained layer's scores per batch."""
    for layer, scores in sorted(getattr(net, "pretrain_scores", {}).items()):
        values = " ".join(f"{float(v):.6g}" for v in scores)
        print(f"epoch {epoch}/{epochs} pretrain layer {layer} scores: "
              f"{values}")
    print(f"epoch {epoch}/{epochs} score: {net.score_value:.6g}")


def cmd_test(args) -> int:
    from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

    props = load_properties(args.conf) if args.conf else {}
    net = ModelSerializer.restore(args.model, device=args.device)
    it = _build_iterator(args, props)
    ds = _full_dataset(it, args.input)
    ev = net.evaluate(ds)
    print(ev.stats())
    return 0


def cmd_predict(args) -> int:
    from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

    props = load_properties(args.conf) if args.conf else {}
    net = ModelSerializer.restore(args.model, device=args.device)
    it = _build_iterator(args, props)
    ds = _full_dataset(it, args.input)
    out = net.output(ds.features)
    if isinstance(out, (list, tuple)):
        # ComputationGraph.output returns one array per networkOutput;
        # the CLI predicts on the first head (matches cmd_test's
        # evaluate(output_index=0))
        out = out[0]
    out = out.cpu().numpy()
    lines: List[str] = []
    if args.probabilities:
        for row in out:
            lines.append(" ".join(f"{p:.6g}" for p in row))
    else:
        for row in out:
            lines.append(str(int(np.argmax(row))))
    text = "\n".join(lines) + "\n"
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {len(lines)} predictions to {args.output}")
    else:
        sys.stdout.write(text)
    return 0


def _add_data_flags(p: argparse.ArgumentParser):
    p.add_argument("-input", "--input", required=True,
                   help="input data file")
    p.add_argument("-conf", "--conf", default=None,
                   help="java-style properties file")
    p.add_argument("--input-format", choices=["csv", "svmlight"],
                   default=None, help="overrides input.format property")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--label-index", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--num-features", type=int, default=None,
                   help="svmlight feature width (else inferred from file)")
    p.add_argument("--zero-based", action="store_true",
                   help="svmlight indices start at 0")
    p.add_argument("--regression", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "cpu runs the plain PyTorch paths)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="train / test / predict with the PyTorch port")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="fit a model from a JSON conf")
    _add_data_flags(p_train)
    p_train.add_argument("-model", "--model", required=True,
                         help="model configuration JSON file")
    p_train.add_argument("-output", "--output", required=True,
                         help="path for the saved model zip")
    p_train.add_argument("--epochs", type=int, default=None)
    p_train.add_argument("-runtime", "--runtime",
                         choices=["local", "mesh", "multihost"], default=None,
                         help="execution runtime (Train.java:75 parity); "
                              "also the 'runtime' property")
    p_train.add_argument("--mesh-devices", type=int, default=None,
                         help="train over the world's first n ranks (the "
                              "others park; default: every rank)")
    p_train.add_argument("--checkpoint-dir", default=None,
                         help="checkpoint dir: saves after every epoch "
                              "(property: checkpoint.dir)")
    p_train.add_argument("--resume", action="store_true",
                         help="resume from the latest checkpoint in "
                              "--checkpoint-dir")
    p_train.add_argument("--coordinator", default=None,
                         help="multihost coordinator host:port")
    p_train.add_argument("--num-processes", type=int, default=None)
    p_train.add_argument("--process-id", type=int, default=None)
    p_train.set_defaults(fn=cmd_train)

    p_test = sub.add_parser("test", help="evaluate a saved model")
    _add_data_flags(p_test)
    p_test.add_argument("-model", "--model", required=True,
                        help="saved model zip")
    p_test.set_defaults(fn=cmd_test)

    p_pred = sub.add_parser("predict", help="predict with a saved model")
    _add_data_flags(p_pred)
    p_pred.add_argument("-model", "--model", required=True,
                        help="saved model zip")
    p_pred.add_argument("-output", "--output", default=None,
                        help="output file (stdout if omitted)")
    p_pred.add_argument("--probabilities", action="store_true",
                        help="emit class probabilities, not argmax labels")
    p_pred.set_defaults(fn=cmd_predict)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
