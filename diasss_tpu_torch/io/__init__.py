"""IO: OpenCV-XML matrix format, survey folder loading/writing (the port's
copy of :mod:`diasss_tpu.io`)."""

from .loader import SurveyData, load_input_data, save_survey
from .opencv_xml import read_matrix, write_matrix

__all__ = ["SurveyData", "load_input_data", "save_survey", "read_matrix", "write_matrix"]
