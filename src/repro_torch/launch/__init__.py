"""Launchers: the step functions and their shardings (``steps``), the
trainer (``train``) and the server (``serve``); the sharding rules
(``sharding``) and the meshes (``mesh``); and the launch layer's analysis
tools on one H100: the card's figures (``mesh``), the analytic roofline
(``roofline``), the dry run that counts FLOPs on meta tensors (``dryrun``)
and its report (``roofline_report``)."""
