"""Entry points of the port: LM serving (``launch.serve``) and detection
serving over the streaming index (``launch.serve_detect``)."""
