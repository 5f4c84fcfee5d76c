"""The port's launchers: ``hvdrun-torch`` (``launch``), the elastic
generation launcher (``elastic_run``) and ``run(fn, np=N)``
(``interactive``). The counterpart of ``horovod_tpu/runner/``; its
``tpu_pod`` has no GPU counterpart."""
