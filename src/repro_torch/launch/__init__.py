"""One-device launchers: the step functions (``steps``), the trainer
(``train``) and the server (``serve``)."""
