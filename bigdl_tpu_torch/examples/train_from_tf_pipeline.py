"""Train from a TF graph that ships its own input pipeline.

Counterpart of ``examples/tensorflow/train_from_tf_pipeline.py``: a
TF1-era export whose input side is ``Const(filenames)`` -> filename
queue -> ``TFRecordReader`` -> example queue -> ``QueueDequeueMany`` ->
``ParseExample``, feeding the trainable model ops.  With no model zoo
on disk the script first writes a synthetic TFRecord training set (3
shards) and a pipeline-bearing GraphDef into a temporary directory,
then imports the graph with ``BigDLSessionImpl`` on the device: the
reader chain is lifted onto the host (the queue-dequeue boundary
becomes an iterator seam), and the MLP fine-tunes under
``DistriOptimizer`` (or ``LocalOptimizer`` with ``--local``) from the
graph's own files.  It reports the Top-1 accuracy over the samples.
The flags are the JAX example's, with ``--device`` added (default the
card):

    python -m bigdl_tpu_torch.examples.train_from_tf_pipeline --max-epoch 8
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import numpy as np

log = logging.getLogger("tf_pipeline")


def write_tfrecords(tmpdir, x, y, shards=3):
    from bigdl_tpu_torch.utils.tf_records import (TFRecordWriter,
                                                  encode_example)

    files = []
    for si, idx in enumerate(np.array_split(np.arange(len(x)), shards)):
        path = os.path.join(tmpdir, f"train-{si}.tfrecord")
        with TFRecordWriter(path) as w:
            for i in idx:
                w.write(encode_example({
                    "x": x[i],
                    "y": np.asarray([y[i]], np.float32),
                }))
        files.append(path)
    return files


def export_pipeline_graph(path, files, d, k, batch=32, seed=0):
    """A TF1-style GraphDef: reader/queue/ParseExample input side wired
    into a trainable MLP classifier (the JAX example's graph)."""
    from bigdl_tpu_torch.utils.tf_interop import (_DT_FLOAT, _DT_STRING,
                                                  GraphDefBuilder)

    rs = np.random.RandomState(seed)
    b = GraphDefBuilder()
    b.const("files", np.asarray(files, dtype=object))
    b.op("fq", "FIFOQueueV2", [],
         component_types=b.attr_types([_DT_STRING]))
    b.op("enq_files", "QueueEnqueueManyV2", ["fq", "files"])
    b.op("reader", "TFRecordReaderV2", [])
    b.op("read", "ReaderReadV2", ["reader", "fq"])
    b.op("eq", "FIFOQueueV2", [],
         component_types=b.attr_types([_DT_STRING]))
    b.op("enq_ex", "QueueEnqueueV2", ["eq", "read:1"])
    b.const("batch", np.asarray(batch, np.int32))
    b.op("deq", "QueueDequeueManyV2", ["eq", "batch"],
         component_types=b.attr_types([_DT_STRING]))
    b.const("key_x", np.asarray(["x"], dtype=object))
    b.const("key_y", np.asarray(["y"], dtype=object))
    b.const("names", np.asarray([], dtype=object))
    b.const("def_x", np.zeros(0, np.float32))
    b.const("def_y", np.zeros(0, np.float32))
    b.op("parse", "ParseExample",
         ["deq", "names", "key_x", "key_y", "def_x", "def_y"],
         Nsparse=b.attr_i(0), Ndense=b.attr_i(2),
         Tdense=b.attr_types([_DT_FLOAT, _DT_FLOAT]),
         dense_shapes=b.attr_shapes([[d], [1]]))
    b.const("w1", (rs.randn(d, 32) * 0.3).astype(np.float32))
    b.const("w2", (rs.randn(32, k) * 0.3).astype(np.float32))
    b.op("mm1", "MatMul", ["parse", "w1"])
    b.op("relu", "Relu", ["mm1"])
    b.op("mm2", "MatMul", ["relu", "w2"])
    b.op("logp", "LogSoftmax", ["mm2"])
    with open(path, "wb") as f:
        f.write(b.tobytes())
    return path


def main(argv=None):
    """Write, import and train; returns the Top-1 accuracy."""
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--max-epoch", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=0.5)
    p.add_argument("-n", "--num-samples", type=int, default=256)
    p.add_argument("--local", action="store_true",
                   help="LocalOptimizer instead of DistriOptimizer")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Top1Accuracy, Trigger
    from bigdl_tpu_torch.optim.evaluator import evaluate_dataset
    from bigdl_tpu_torch.utils.tf_interop import BigDLSessionImpl

    Engine.init(args.device)
    rs = np.random.RandomState(11)
    d, k, n = 16, 4, args.num_samples
    wtrue = rs.randn(d, k)
    x = rs.randn(n, d).astype(np.float32)
    y = (np.argmax(x @ wtrue, axis=1) + 1).astype(np.float32)

    tmp = tempfile.mkdtemp(prefix="bigdl_torch_tf_pipeline_")
    files = write_tfrecords(tmp, x, y)
    pb = export_pipeline_graph(
        os.path.join(tmp, "train_graph.pb"), files, d, k)
    log.info("wrote %d TFRecord shards + pipeline graph %s",
             len(files), pb)

    sess = BigDLSessionImpl(path=pb, device=args.device)
    log.info("lifted pipeline: seams=%s batch=%d files=%d",
             sess.pipeline.seam_refs, sess.pipeline.batch_size,
             len(sess.pipeline.dataset.filenames))
    trained = sess.train_with_pipeline(
        ClassNLLCriterion(), label_key="y",
        label_transform=lambda a: a.reshape(-1),
        optim_method=SGD(learningrate=args.learning_rate),
        end_trigger=Trigger.max_epoch(args.max_epoch),
        distributed=not args.local)

    (acc,) = evaluate_dataset(
        trained, ArrayDataSet(x, y, 64), [Top1Accuracy()],
        device=args.device)
    value, _ = acc.result()
    log.info("fine-tuned Top1Accuracy from the graph's own pipeline: %.4f",
             value)
    return value


if __name__ == "__main__":
    main()
