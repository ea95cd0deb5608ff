"""Launching PAC over several ranks: the mesh over ``torch.distributed``
(``mesh``) and the multi-process launcher (``pac_cluster``)."""
