from .traces import (TraceRequest, make_trace, TRACE_PROFILES, scale_trace,
                     SCENARIOS, SLO_CLASSES, make_gamma_trace,
                     make_longcontext_trace, make_scenario,
                     make_slo_class_trace)

__all__ = ["TraceRequest", "make_trace", "TRACE_PROFILES", "scale_trace",
           "SCENARIOS", "SLO_CLASSES", "make_gamma_trace",
           "make_longcontext_trace", "make_scenario", "make_slo_class_trace"]
