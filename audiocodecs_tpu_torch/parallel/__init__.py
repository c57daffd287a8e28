"""Training and the parallel layer on ``torch.distributed``: the process
group and mesh (:mod:`.mesh`), the collectives with their gradients
(:mod:`.comm`), the codec and SLM steps with their sharded layouts
(:mod:`.train`), expert parallelism (:mod:`.moe`), GPipe
(:mod:`.pipeline`) and the multichip dry run (:mod:`.dryrun`)."""
