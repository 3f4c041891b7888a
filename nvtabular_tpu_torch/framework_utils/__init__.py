"""Framework bridges (counterpart of nvtabular_tpu/framework_utils/): not
ported yet; each of the reference's names raises naming its ROADMAP item."""

from ..unported import stubs

__getattr__ = stubs(__name__, {"convert_tfrecords_to_parquet": 15, "make_feature_column_workflow": 15})
