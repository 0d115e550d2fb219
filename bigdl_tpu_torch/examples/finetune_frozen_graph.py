"""Fine-tune a frozen TensorFlow GraphDef through ``TFTrainingSession``.

Counterpart of ``examples/tensorflow/finetune_frozen_graph.py``.  With
no model zoo on disk the script first exports a small frozen MLP
classifier (``x -> fc1 -> relu1 -> fc2 -> logp``) with
``TensorflowSaver`` into a temporary directory, then imports it with
``TFTrainingSession`` on the device and fine-tunes it with SGD on a
synthetic 4-class task (16 features, 1024 samples), through
``LocalOptimizer`` or, with ``--distributed``, ``DistriOptimizer``;
gradients flow through every imported op.  It reports the train-set
Top-1 accuracy.  The flags are the JAX example's, with ``--device``
added (default the card):

    python -m bigdl_tpu_torch.examples.finetune_frozen_graph --max-epoch 8
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import numpy as np

log = logging.getLogger("tf_finetune")


def export_frozen_classifier(path, d, k):
    """Build and freeze a small MLP classifier as a GraphDef file (its
    weights drawn from ``RandomGenerator.RNG``)."""
    from bigdl_tpu_torch.nn import layers as L
    from bigdl_tpu_torch.nn.graph import Graph, Input
    from bigdl_tpu_torch.utils.tf_interop import TensorflowSaver

    inp = Input("x")
    h = L.Linear(d, 32).set_name("fc1")(inp)
    h = L.ReLU().set_name("relu1")(h)
    h = L.Linear(32, k).set_name("fc2")(h)
    h = L.LogSoftMax().set_name("logp")(h)
    TensorflowSaver.save(Graph(inp, h), path)
    return path


def main(argv=None):
    """Export, import and fine-tune; returns the train-set accuracy."""
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("-e", "--max-epoch", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=0.5)
    p.add_argument("--graph", default=None,
                   help="existing frozen GraphDef; default: export one")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Top1Accuracy, Trigger
    from bigdl_tpu_torch.optim.evaluator import evaluate_dataset
    from bigdl_tpu_torch.utils.tf_interop import TFTrainingSession

    d, k, n = 16, 4, 1024
    rs = np.random.RandomState(1)
    w = rs.randn(d, k)
    x = rs.randn(n, d).astype(np.float32)
    y = (np.argmax(x @ w, axis=1) + 1).astype(np.float32)

    graph_path = args.graph
    if graph_path is None:
        tmp = tempfile.mkdtemp(prefix="bigdl_torch_frozen_")
        graph_path = export_frozen_classifier(
            os.path.join(tmp, "frozen_mlp.pb"), d, k)
        log.info("exported frozen classifier to %s", graph_path)

    if args.distributed:
        from bigdl_tpu_torch.engine import Engine

        Engine.init(args.device)
    sess = TFTrainingSession(graph_path, inputs=["x"], outputs=["logp"],
                             device=args.device)
    trained = sess.train(
        (x, y), ClassNLLCriterion(),
        optim_method=SGD(learningrate=args.learning_rate),
        batch_size=args.batch_size,
        end_trigger=Trigger.max_epoch(args.max_epoch),
        distributed=args.distributed)

    (acc,) = evaluate_dataset(trained, ArrayDataSet(x, y, args.batch_size),
                              [Top1Accuracy()], device=args.device)
    value, _ = acc.result()
    log.info("fine-tuned Top1Accuracy: %.4f", value)
    return value


if __name__ == "__main__":
    main()
