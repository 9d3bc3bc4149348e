# Host-side tracing of the port (the reference's trace event schema).
