"""Cost analysis of the port's steps: the op counter (``hlo``) and the
roofline (``roofline``), after ``repro/analysis``."""
from .hlo import HLOCostReport, OpCounter, count
from .roofline import H100, HW, RooflineTerms, roofline_from_report
