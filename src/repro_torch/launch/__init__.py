"""Launching PAC over several ranks: the mesh over ``torch.distributed``
(``mesh``) and the multi-process launcher (``pac_cluster``); the training
CLI (``train``); the dry run, every architecture's program costed on the
``meta`` device (``dryrun``)."""
