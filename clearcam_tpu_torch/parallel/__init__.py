"""Multi-device paths over torch.distributed (one process a device): the
mesh, detection and LLM sharding and the leader/follower channel
(``mesh``), the collectives (``comm``), multi-host federation, ring
attention, sequence-parallel prefill and pipeline schedules."""
