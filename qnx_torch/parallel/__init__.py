"""Data and tensor parallelism over ``torch.distributed`` (the port of
:mod:`qnx.parallel`): the (data, model) mesh, the sharding rules, the
ring-overlapped TP GEMM, the TP packed forwards and the multi-process
bring-up.  Ranks are processes, one a device or several on one card;
:mod:`qnx_torch.parallel.launch` starts them."""
