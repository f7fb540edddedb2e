"""Multi-process layer of the port: the process group (`distributed`), the
(data, fsdp, tp) mesh of process groups (`mesh`) and the parameter plans
and collectives of data, fully sharded and tensor parallelism (`sharding`)."""
