"""LambdaOp: the DAG-level UDF op (counterpart of nvtabular_tpu/ops/lambdaop.py)."""

from ..dag.ops import UDF


class LambdaOp(UDF):
    def __init__(self, f, dtype=None, tags=None, properties=None, label=None):
        super().__init__(f, dtype=dtype, tags=tags, properties=properties, label=label)
