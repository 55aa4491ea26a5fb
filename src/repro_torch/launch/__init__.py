"""One-device launchers: the step functions (``steps``), the trainer
(``train``) and the server (``serve``); and the launch layer's analysis
tools on one H100: the card's figures (``mesh``), the analytic roofline
(``roofline``), the dry run that counts FLOPs on meta tensors (``dryrun``)
and its report (``roofline_report``)."""
