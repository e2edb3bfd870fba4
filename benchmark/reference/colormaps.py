"""matplotlib's 256-entry colormap tables, as the byte RGBA rows a figure's pixels take.

The tables are matplotlib's own (sampled at its 256 native entries, with the
truncation of ``Colormap.__call__(..., bytes=True)``), stored zlib+base64.
The reference reads a panel's colour index back from a PNG pixel with them;
only the five colormaps the benchmark's CLIs use are kept.
"""

from __future__ import annotations

import base64
import functools
import zlib

import numpy as np

_TABLES = {
    "viridis": (
        "eJwtwwlM1QUcwPFVq9VqtVo1QHyPx30JyH3L8d77P8IjFAQEueQQue/7lsfx3v+fWWZZZllmWWZZZllqUWqaV3ig"
        "CAIGuLbW1tpaa2vffm1+to/xvnSM92dgfCAT04NZmB7agOnhHMyP5GJ+NA/zY/mYHy9EeaII5clNKE+VoDxdivJM"
        "Gcqz5SgOW7A4VmBxqsTiXI1laQ0WXS0Wlzoshnosrg1Y3BpRPJpQPJtRvFpQvFtRfNtQ/NpR/DswL+vEHCiDujAv"
        "78YU3IMpVIb1Ygrvwxgho/pJjh4gOUbGbiUpTsYPkpQwSGKilcQkKwnJQyQYh1hhksow8RaZMkLcczJVrhwhdtUo"
        "satHiXlepo0SvdZG9DobUekyw0bkeplpJyJLZtsJ3yBz7ITlyo12QvNUQvNVQgpkoUpwkdyksrxYlshSlaAyuVkl"
        "sFxuUQmo0AiolFUay6pljYZ/rayT9Rp+DbJRw7dJNssWDZ9W2abh3X5vh4ZXp+yS3RqePbJX9ml49MsBFfetclBa"
        "VdyG5LAcUXH9/6i0qRjsUrVj0Oy4vCC3yRft6LfLl2zoX5Y75Cs2dDtH0b0qX7t31wi61+UbcvcwujflHvnWEPq3"
        "5V4r+nesuLw7iMu+QQzvyf1bcZVu7w/g9kE/7gf68fiwD8+P+vA62Iv3xz34HOrB95Nu/D7twl8GHO4k8LMOgj5v"
        "J/hIOyFftBF2tJXwL1uI/KqZKBlzrIm4rxuJ/6aBhOP1JJ2ow3iiFtPJGpRvq0n5rorUsUpWjVWw5vty0n7YzLpT"
        "ZWScLiXzdAnZZ4rJ+bGIvLOFFJwtoOhcPsU/baTsfC7l53OouJBN1cUsai+up/5SBo2X02m5vJa2n9PoHF9D9/hq"
        "+q6sZOBKKtarKQxfU7BdM6NeN7LtejLbJxLZMbGCnTfi2XUjlt03o9lzM5K9kxHsmwxj/60QDtwK5uBUEIemAjg8"
        "7c+RaT+OTvtw7LYXx297cnLGnbEZV07NGDgzq+fcrI4Ls0u5NOfM+NwSrs45MXHHkck7DkzJmV8cmJPz8u68I7/K"
        "3+ad+H1hCX8sOPPngo6/FvX8vWjgn0VX/r3rzn+6SUgO"
    ),
    "cividis": (
        "eJwlx1VsVgccQPH7sIclJEuWLMuybFnGYDBgaGlLS2lpS1vq7t6vevXTe0txd3cp7u4Og+IUGU5h6GC+ZZpJmrN/"
        "0odfTo7SOQXlkzSRjtIlE6VrNsqnOSIPpVsBSvciUYzyWSlKj3JRidLThdKrRtSifF6P0ltF6aMLE6Wv1aFfhzf6"
        "W7w5wKKTeCvI4u2BJu8Em7wr3gsxeT/U5INQgw8HGXwUZvBxuEFn0WWwQdcInW6i+xCdHpE6PUWvKJ3eQzX6RGv0"
        "Ff1iNPrHagSJgcM0guM0QkRovMagBI2wBJXw4SoRiSpDklQiRVSyytAUlWgRk6oSm6YyTMSlq8RnqCSI4ZkqiVkq"
        "SdkaySIlRyM1t0NankZ6vkaGyCzQyCrUyBY5RTq5xTp5JTr5oqBUlOkUiqJyg+IKgxJRWmlQVmVQ7jKocJlUVJtU"
        "1phUCVetSXWdRU29Ra2oaxCqm3rRoLlRdTea7kE3PBimsLyYwnJ7cXu8eLw+vMLn8+Pz+/GLQCCAbQdwnACNjk1j"
        "o82IETZNTTYjmxxGjXQYPcphjBg72mHcGIfxYx0miInjHCaNFxMcJospEx2mTnKYNtlhupgxxWHmVIdZ0xxmiznT"
        "bebOsJk302a+WDDLZuFsm0VzbBaLJXMDLJ0XYNn8AMsXBFghVi4MsGqRn+bFflaLNUv8rF3qY90yH+uX+9ggNq7w"
        "smmll82rvGxp9rK12cO21R62r/GwY62bnevc7BK711vs2WCxd6PFvk0m+8WBzSYHtxgc2mpweJvOke06R8WxHRrH"
        "d2qc2KVycrfKqT0NnBZn9tZzdl89LfvrOHegjvMHa7kgLh6q4dLhai4fqebKURdXj7loPV7FtROVXBc3TlZw81Q5"
        "t06Xc/uLMu6cKeXu2VLutZRwv6WYB+eKeHi+kLYLhTy6WMDjS/k8uZzH0yu5PLuaw/PWbF60ZvHyWiZfX8/g1Y10"
        "Xt9M49svU/nuVgrf307mhztJ/Hg3kZ/uJfDz/Xh+eRDHrw9j+a0tht/bovnjURR/Po7kr68i+PtJOP88DePfZ6H8"
        "9zyY9hdBtL8cQPsr6Wv5b0L4H39vYYM="
    ),
    "plasma": (
        "eJwNwwlcDXYAwPF6vVfbPrbZzGc2M59W74UklETSsZKiUiiFrnUtRUqplVTr0H3f9/niw5iNMWaMMWOmmWtYhoaG"
        "7vu9z2//7+fznaKTwVSdTKZpZzFdO5sZ2jnM1M5llnYes2X56MoK0JMVIpcVYSArZq6sBENZKUbSUoylZSySlmMi"
        "rcBUWomZaC6tYrm0Ggutaiy1arDSqsVatNWqw06rHnvRQdKAo+gkaWStpAkX0VXSjJtmM+6aLWwQPURPzVa8RG+N"
        "NraIPqKvRjv+YoAYqKEkSAwRQ8UwMVyjgwhxhxgpRonRYowYq9lBnBgvJkg6SJQoSdJSsldMkSpJFdNk7aRrt5Oh"
        "084+nTayXmsj5/VWct9oJX9KKwVvtlD4VgvFbzdTMrWJsneaKH+3kYppjVS910D19Hpq3q+nbkYd9R/U0vBhDY0z"
        "a2j+qJqWWVW0flxJ2+wKlLoVdHxSzn69Mg7ol3JQXsIhRTFfGRRxeE4hR+YV8LVhAUfn5/OtUR7HFuRy3DiH7xZm"
        "c2JxFidN9vG9aSanlmRw2iydH5amccb8S35clspZixTOrUjmJ8tkzq/cywWrJH623sNFm0Qu2Sbwi90XXLaP59dV"
        "cVxx2M3V1bH85hjDNacYfl+zi+vO0XS6RNHpupM/1kVyw20Hf7pv5+b6CG5tjOC2Rzi3PbdxZ1MYd70+5y/vUO5t"
        "DuH+1mDu+wTzwDeIv/0C6fL/jK6AAB4G+vNPkB+Pgv14HOLL41AfnoRtpXvbFrrDN/NvhDdPt3vzLNKLZzs38TzK"
        "k55oD3p2beS/2A282C3GredlvDsvE9x4lbiO3j2u9Ca50JfsTF+KM/2paxlIW8NAuhODGY4MZq5mKMuBoWwHhnNW"
        "MZxnz0i+HSMFnzJSZMtosQ2jJTaMlVkzVm7FWOVKxqssGa9ewUStBRN1y5loEBuXMdlszmTLUiZbzVC1L0GlFPeb"
        "ojpggurgYlSHFqE+LB5ZiPqoMepvFqA+ZoT6uHhiPuqThqhPiafnoT4zF/VZ8dwc1OfFCwaoLypQXRIvi1fkqK6K"
        "1+RMXtdnslO8oc/ETfGWeEef8bviPX3GHohd+ow+FB/JGXkidssZfqpg+LmCoR4Fgy/EVwoG+sR+Bf2DCvqG5fSN"
        "6NE7psv/A1x1+A=="
    ),
    "inferno": (
        "eJwNwwlQVHUAwGEu2X37lhUQERDkkkPuS5BDTjkEOQIE5JBDbnY3xrTS0pFxKK10ZBwqxnSoGLscy8qxcsyxcswx"
        "x6zMMc0cM9IMY3c5dvdZv/7fzOfg4IyDg4voiqODCkdHSZRxctTh5OSOs5MnLs5eojcLXHxwdVmKakEAatdAJNdg"
        "NKpQZFU4bupIdOooFkqxuEvxeGqSWKRJwUtOxVtOZ4mcia+cjZ+ci7+2gABtIYHaYoK0pYTI61guVxAuVxEhV7NC"
        "riVaU0espoE4TSMJmmaSpBZSpFZWSm2kSe2kSx1kSp1kSV1kS93kinlSDwWaXgo1fRSJJXI/pWKZdoBysdJNT5VY"
        "rdNTozOwfqGBerHB3UCjh4EmDyMtnkZaxbZFRjq8jGwSuxYb6RZ7vY30LzEyIBp8jBjFQV8jm30NPOVnYOtSA0+L"
        "z/ob2C4+F6Bnh7hzmZ5dgQMMibuDBhgO6ueF4H72iHtD+nhZ3Bfax/7lvRwQR8J6OCiOhnfzqvh6RBdjkZ0cEt9Y"
        "sYkj4nhUB29Gt/O2OBHTxtGYVt6JbeW9uI18ENfCsfhmjic08WFiEycSG/k4aQOfJjdwMrmeUyl1fLayji9S13M6"
        "rZYzaTV8uaqas+lPcC6jiq8yK/kmq4Lzq8u5kL2Ob7PLuJhTyqXctXyXV8Ll/GKurCni+8I1XC0q4IfifH4qyePa"
        "2lx+Ls3helk2N8pX80tFJjcrM7hVlc6v1au4XZPGb7Wp3KlL4W59Mr83JHGvMZE/mhKYbI5jcmMsf7bGcL89mgcd"
        "UfzVGcnDrgj+7glnqjeMqf5QHulD+McQzPSTgUwPLsO0OQDzFn/MW/2wPOOLZZsPM9u9mX1+MbM7vZjb5cnckAfz"
        "u92ZH9ZhfdEN6x4t1pdkbK9I2ParsR1QYx9RYT/oin1UfM0VZUw8JB4Wj6hQxsW31CgTGpSjMsq7bijv61COuaMc"
        "90T5yAvlhDfKJz4oJ/1QTvmjfL4M++lg7GdCsZ8Nw34uEtvXUdjOx2C7EI/1YiLWSylYL6cxfyWD+atZzP2Yw9y1"
        "fGavFzJ7o4SZm2XM3KrEcrsay506LHc3YL7XgnmyDdP9TkwPejE91GOaGsT0aAum6W2YzDswW4YwzwxjmdvLzPw+"
        "Zq0jzNlHmVfGsD0+jP3fcR7/N8H/k8Q5iw=="
    ),
    "magma": (
        "eJwNwwlQVHUAwGGQS873HoioqBgqEaKgSIoSKt4SRRSpLQsLyI3c9y57kJqammEMaRpDGpkxJMOQMaQ5VnY4VpZj"
        "5WhlpTlmpJkZ7Hvv1/+b+Vxc3HBxcRc9cXXxwtXVW/RlzBh/UcLNTcHdLQh392A83EPw9JiIl0coYz2n4O0Vho9X"
        "OL5jZ+DnHYG/TyQBPlFIvtHIfjEofnMJ9I9jnH88wQELGR+wiBApkQnSEibJywiVVzBZXsVUeS1hSgrTlFTClTSm"
        "K+nMVDKIUNYTqWwkSslklpLFbNlEjJxLrJzPPLmQ+XIR8VIJC6QyEqRyFksVJEpVJEnVLJVqSJZqWS7VsVKqZ7XU"
        "wBq5kXVyEyliqtLMk4qZtEAz6YEWng6ykBHUwvpxLWwItvKcaBhvxRhiJSvEhmmCjRwxb6KN/El2CsSiUDvFk+2U"
        "imVT7JRPdVAhVoU5qBFrpzmof8hBg9gU7qBZtEx3YJ3hwCY6ZjpoFbdEONgqvvCwgx2RDnaKux6xs1t8KcrOy2Lb"
        "LDuviO3RdjqibeyfbeOAeHCOjdfnWOmMsdIlHo61ciS2he65Lbwlvj3PwjtxFnrizPTON3Nc7Itvpl8ceLSJ98T3"
        "FzQyKA4tbOBkQgOnEuo5vaiOM+JHi2v5JLGWs4k1fPZYNV8kVXMuqYrzSyr5cmklXy+r4EJyOd8mb+bi8s1cWlHG"
        "dytL+WFVCZdXF3NlTTFX1xbx47pCfk4p4NrjBfySms9vT2zieloeN57K5ff0XG4+k8OtDBN/PGvi9oZs/tyYzbAh"
        "i2Gjkb+yjNwxGbmbk8nfeZncyxcLDfxTZOB+iVhm4N9ysdLAgyqxJpP/6sSGTEaaRLORkRYjo7YsRu1iazbOLSac"
        "28TtOTh35qLuykPdI+7dhNqWj7qvAK29EK2jCG1/MdprJWiHStE6y9C6ytHeqEA7UoneXYV+tAb9WC16Tx16bz36"
        "u43ofU3o/Wb0AQv6iRb0QRv6kB39g1b0U8+jn96KfmYb+sfb0c/uQP/0RfTPd6Of24N2fi/aV21oF/ahfdOOdrED"
        "7dKraN8fQLt8EO3KIbSrnWg/daFdO4z665uo17tRbxxFvXkM9VYP6u1e1OHjqHf6UO/2o94bQL1/AueDQZwjQzhH"
        "T+JUP+R/WbFdqQ=="
    ),
}


@functools.lru_cache(maxsize=None)
def lut(name: str) -> np.ndarray:
    """The (256, 4) uint8 RGBA table of colormap *name*."""
    raw = zlib.decompress(base64.b64decode(_TABLES[name]))
    table = np.frombuffer(raw, dtype=np.uint8).reshape(256, 4).copy()
    table.setflags(write=False)
    return table
