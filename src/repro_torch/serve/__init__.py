"""repro_torch.serve — the serving plane's ingress admission control
(``AdmissionPolicy``, ``IngressGateway``), behind ``Session.open(...,
admission=...)``.  The always-on multi-job service and its round
scheduler are not ported yet (ROADMAP A.4, the next slice)."""
from repro_torch.serve.gateway import AdmissionPolicy, IngressGateway

__all__ = [
    "AdmissionPolicy",
    "IngressGateway",
]
