"""The roofline on the H100: its constants (``hw``), the work of each
hand-written kernel (``kernel_work``), the count of what a step dispatches
on meta tensors (``trace_analysis``) and the dry run's report
(``report``)."""
from . import hw, kernel_work  # noqa: F401
from .trace_analysis import Cost, CostMode, analyze  # noqa: F401
from .report import load_records, model_flops, roofline_fraction, roofline_table  # noqa: F401
