# The port's analysis modules: the tracer (trace), its replay cost model
# (replay), the H100 roofline (roofline), program cost of dispatched ops
# (profile) and sidedelta path autotuning (autotune). Import each module
# by name; this package imports nothing on its own.
