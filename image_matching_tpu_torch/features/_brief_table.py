"""The default ORB test pattern's unit normals: float32 (256, 2, 2), the
values of `jax.random.normal(jax.random.PRNGKey(7), (256, 2, 2))` (the
threefry PRNG, partitionable), little-endian and base64-encoded.
`features/orb.brief_pattern` scales and clips them."""
from __future__ import annotations

import base64

import numpy as np

SEED = 7
N_TESTS = 256

_B64 = (
    "SwjnPq4K+j9FKAS/p1IQvjGRHT+IK6s+sG0Evi4bZb5hIL2/99Orv3tKqL6n5n8/VjQHPxmI37/Eq7w/p3oavSBvgr7ZUzs/"
    "fWuvvmC++T/16cE/WcyFvtPjxL77dO4+WNQwPzsDmb+KSEs/yfm5vg71fj3Ewgq/1O/bPx/D8L/TgbE/pYMXv8su9r/lStM/"
    "BFSzvzkDUj1vhV4+VmjCviFveL9mHX0/amVkv6RH5L1lOxg+5mdePw/NyL6o2g8/6VmHvjtTFr+NWU2+C1XFvDrLXr/07gI/"
    "bCKZPq1AlT5aFiS/f2wPP2juQT2v3yi+b8sVv/Ud6j/iXNu/pbmYvuhVbr+v4WA/Tu9Lvq0oFT9MIjm+uISEvvPuhz+UqcQ/"
    "3FKsv0yifz87V5s/HkbBPmZB5j+lr4s/iJ1LPrYPTT+6t9s+HR87P6JDmT+3JVM/WBNxv9Rknz/2Yiu/oT2JPqc2uz6EtKU/"
    "biKGPYa71L42maw+Or9YwDRnhT8tsL69sZwEvyfJHT/7KCLATxMJv9IXtD/KUEQ+IlywPTI/eT+6Rtg83FJ4P64P/b60Prw/"
    "nnARv+H0Or6y5QPAr85rP1V6M78SOfM+SGczv7Scgj90nQtAc+Sgu58gzz4XSCE/Zg2OvtugmL8Qmvi9BjWovpuFUr+EKbw+"
    "HXt/Pus0IT5vydE+mUIxv8nu3z+0dVo/Qgosv3Z5BD/EsN+/QoNmPg1MSL8eV4Y/CsHcvetIx73kY0A//1GcPtEZc79CASpA"
    "HHlhPkGq5z5CJf6+hnTSvnf2WL/Nu6S/Izq4PiYKrT6NGTC+maHRv5o0eD06/O++ogxqvp47GT2a5hfAOwcNv2p1db9ADhZA"
    "h/6mPLMUcT/VX56+g5zJvrcLHj+ptx3AQkJjvwk8qT2NafS816QrP9Kalb89bGO/pgtCv00hy78Tyvy+mikDP4a/tL9pfJQ/"
    "l/RDP+1b6b8qRLG//mo1v3mljb8ypArA7WgEQEah5r+i6T+/JVvvP2ziTL+pa4A/pKqEP/jOHD9yUoe/7pRyvhlpyL9HNE2/"
    "gfpQv/QkUb/OMp8/7Mh0vp7jzL9o2jg/ULU4P/fduj2OjjS+to19P3l29r4HPju/qx6bP1xfHT+gJN+/G3yAvw0hpT7JxNi+"
    "vpCave4z5T8A8hi/5JVxP1yPsr+aWCe/gy6Vvo2f9r6aykm/P+WAP0jG8z/ssZg+gn0uP4T2tjyCPSg/K/o7PyxzQb9gpJW/"
    "NXNEP8WykD8KQwy/sbBovloCWT6yW9m+ldrAv9ELgz3MuR5ABDzhvWss7r6I0N+/C2NGP8U1oT+eJZ08hFyEP846qj5mMPk8"
    "vj8vv7E2yz5aI/o+9fDevqqDGD8mj9+7uwopvx/Ho7+9i+E+IgcgP7HuyT4N0Y+/1tflPbl9JcANwSg/b5RsPpd5rj8I6uG+"
    "f2wGvxxHYD8rmpg/9wIqvqO+0b9Ly3C/VBvvvlwKEcDW1r2+05UAP8hB6z9Vjae/WRuQPlDPCr7pEcs+GAI9QOsmr76IaWO/"
    "WE7uP58Xsj9AEaK/ifxEvooDC78h/jY/w4znP5xElD90nce/PoIJPix4oj/8tBQ/TDXrv0h7f79u06w/4bZfv8JwN8D3dOQ9"
    "MRPcv7L4WL7r95Q/sTBbPuEgWD8v1da/WQ9OPpO0G79ZWJ6/pQgSv6I9ST+Ofiu+EM5iPw1o37+SHva798APv5gcYz48jL0/"
    "Wgt3Plz9ub/Ejjw+HWaBvhe9x70l1Q0/Veevvwsamr9IzY4/S1CFPt/75z0QcL8/kZnSv3mmMEAvs60/9IaKPvgotT9w65o/"
    "JS8Lv9PWDcD1REC/qDUjPrlrCD559Bk/zmYDQLq2d7+Zdv276gmivx1UeT68XDU/lAArQN64gz/J35a/elQvwO+h1L0xsXq+"
    "v8LaPq1QJb/btgi/BSGVP8vGvL7gPry8QA0HwKahwT8vn0A/cIUQPXtwz75K47e+T30jP8SqND09jy6/1bWLPO69RT7WE/w+"
    "WKChvmGGJD4WEY87NeEZP9Gndj/p0ay/z9d9vwTelL+p7U6/L5DSvmMlRT9bAiQ/HR2FP2CA+b+iOZa/+O4OP35S3jwfSqE/"
    "S6mvvu/Szj4wlAy/bOfivkbAHD8w3k6/2UCivjPQqL/Eviw/dI3pPGW377+hjFi9BvjfPl0Gzj81NcE/Vcr2PiFCVz/QvwM/"
    "7n/fP0oADr9UdgM/wQZUv2Zm5z1jUNK+wSwsPR3+EMCDazg/FbQGvpHBrT440iHAn5ZjvW278L9VARw/b1wXwLdEo78L6QM/"
    "cdtLP5SGHr+cdqC+vyosPvWd5T6cVDM+76nCP1xAqT+JFTm/z3aavk8Svj4/COg+gXsHwJRa0j/YI9A9z+TUv692DL+ACyC+"
    "fNpXP1bEVL+nGH++yS6wvnwbuj7PQAa+1GaPP/Lzoz3lCXy+Pto3v1pFYz+PGHq/i+u5Pbelfz+xNAK/IyoEP192FMCh4FW9"
    "zxWlviCUKz5+eOc+k3QLvbijED9JFQi/EjKjP7QgQ7+LWM88ZSiXPqP73T5W/zi/aAvaPnBiEL+NtLq+HkwMPcNITD+YmkO/"
    "zfW0v6QVBkDVFo6/oLQKPxsUkz9wrE8/J2qIP3IWgT+EBcE+a8KlP2bDhr8n0b4/MREjPxyT/D+92kg/WYgnP7ljcb8GJww/"
    "pNQgPsz6DEDc1xnAR1+ePpvg0D65hIU+/FgvP1d1Xz8s+qi+N8jLv1mtrr6/NKQ/06WXvvctGUC8c76+Zz+oPzVhlb9+aAQ/"
    "HVQpv+iRlj/eb62/yHKBP4/eGD4RaLW+0weavuSTOj/vjzY/MU7SP4sMeT7dAgU/3g1rv2X1/b8jPbs+vDPhvtk3Y71fFgRA"
    "Jb+ev0/L3L9kjAS/tQsHwNhDHz8fHqi+paICPyhPcj93vy2+oLCyPtNEJr7IgmK/dO+Fv+v4jz+WPYC/P0tiv+CpKr+NXL+/"
    "AD+Nvpuu4D5Y7Bc/ihPOPfgKez8LQ8u+U96APgqdZT9wZCM/7L0dv1kk0j7RjpQ/pPLnPuJQKT+XlI6/ihG7P8lUKj0dmoe/"
    "XUHfvjAYaz83xUu8sYIxP/ZUIT+arAu+Wf7uPhe99j7mXpA/wS2RPubJUr9eOTW/VDW+P0YKtj+k0xTAqLeYPrX3fb/y/Lg+"
    "pRUgv4uJHr/vxzY/jjq+P84A7z/NrIA+KTbLPzQTkD6r+I49fd7ZvjgzPD9IVgG+GFmCP0lnA0Dg6+Q+h2GzvysxFUDVDqk+"
    "re1yP2e5gT4r9g69Wa4jvynQ878LwJo+yn4Bvkf7o785sMI/hV2UPogJYj9vN/w/SdCNP4o3/74Xx40+yQh0vqVDsr6fDNQ/"
    "4ZHKP/ruh7/Qanc/L0dzPiuT4j/B0Xk+qXFDP1IQkr4iAro/rjXlPytpjL/IeDO/c4acPwDlUL8x/Uc/cSYXPyyjuT9KI0s+"
    "FaPKP9O5wz89nwxAaMCXPq3niz9iGoo/4q15vugb/75KAZ29KL6BP8pktT6a3bK/5zACvwhQkb9ogr8+mXkBQEA+Rz3p5rg/"
    "VHq0vXcan7+O5qm/61cbvz4Lqb9ECjTA3S98P+7MmL/KZxo/7gmvv/Ga6D9Pblq+uLq3v2VWL7+z400+MwYhP5JAJT9207O/"
    "OqtfP+f2YL/FBhY+G0vEvjt6l78yAn0/98FFvicFHr5poyQ/fI8uv+/T076zqRC/jm9vPzTWJcAY7Yy/bp0bwO+1ML40LNe+"
    "TiiyP6Gshj+CorG9HAUnPo++yL6WjKk+5dj1PchEpT6NCpo+RG3xPoPRX78dkIC/rsuFPg1OMr+QCB5AiqVAv8RYq7909eg+"
    "eC6UPu4TSb6ViTI/uZdYPrBaej9PbPo+iTG2PWmbCj+9U1M/RelmP9fQhj94T76/r/QJPes5rT0WeYc/vgwQv32Y/j/b9gG/"
    "pknBPw2Ygr+Ty7E/OreZvhAniT8CKVa/xTvUv0oKHL4MGZu/IDrFv5uH674kLoQ/k8coP9UTbj89ygs/X1TDv6rws79iqSe/"
    "iEKkPtDrXT+VvF2+vDeCvz2MM799gR2/ZfiFvxSnTT82fIA/FSkmP47Y1z4Rfo++dvwzP3k7tr9venO/aHmXPoMIEz+NkGi/"
    "TKkSv4w09L/enXm/hYSDPwZVuT+ne20/zSD6PyHgJj8y220+ls9zP0RiYL8gGwE/CejiPGz3Y76A+MO+/mOUP8ZWGD/FGky+"
    "pL2gPkn6i7+HYkK/+YpdOvjrTL9AhAy/9tirvvv+Z7+giIG/gZKKP3WLLz4vh7C+m0omv7xJwr7W99I+L636vrk/n799RS0/"
    "5+a5P+quJb+2aGi/pm0CvwSeCz9jOxa/gz9CP3MO6z4fLXC9PKgOv7VYWj9oawk/AwDnPuHghj2yyV0/qyGMP8ozpz8oEao/"
    "8BdOvhrLK7/Flve+u7iKvxyPZD+BZZY/Gtxqv6bq475De8S/bIcgP2mHrr5bBro+Sxjjvvw/oj9A9No/172JP/8DDb9XH00/"
    "7G32Pv6Lz76WjPO+Mst/P5K6MD+MMcc9zzHtvx/37j0H4sI+A6yUv0BMTL9VuJ8+zWN3vypfK0D3ZTY/wfbePvgRFT4YvYE/"
    "FZm2vmOIjT/IMAdAsYTAPWmX9b8lYUc+N4wlvp+dfD8pCHi/kUSEvwUcBz8f4ji+foguv51Spr6zq96/v20qPgzWnT9e8oI+"
    "Ax8TvguqN74SQdE+k2DFvxYiwjwcv7E+vznwvleEeD1Gg3a/DgPKPwt25z9SgGK/B2sFvzsgKz/pdvA97QTzvuCx4L8HLbA/"
    "dNn9v5dbHL9n4iHAHH6Gv8tEhb+U8DS+Eju7v6JFL7+UrhvAusrCP3xArD/9kmG/gk4yP1OLnj5RCYO/tzaev2Wn77/Dv6i/"
    "vUq+v/t88j0zlBg/hLgXvsJrlT+dqR4/ZTraP9LmxL5fUNi+YqpSv6Kt8z1W5FQ/BgHPvvlO+b/6QTk9fnaLvcIsz74uiA0/"
    "eTktP/ahoL+oY0g/xYKJv4ZB7j5Mxea/j/mzv9/qHD+i4SW/G6VYvdPwEL8GI4Y+apIFQJDC17+VTke/gv4tv81Fa7+jRJ8/"
    "N+tQP2NS/r+QDDq/eP4HwOWTVz5P1JU/Lg6PPRZdsb9R9+G/+475PqCinDzIgby9EEsMP8P0yD6MQpK/bW0iPs7Bu754HoI/"
    "5LUCv8fQxD6V8HO/VbakPlTIKr9fbeg/bdzEv44fq7/x14q/68h0P834n78SuQZA723IvwFeVb7iYVQ/NvmRvQrAiz5PXA4/"
    "1azdvwvZPMBKggY/m9SHvw9zcb+e0u29t8IHv/fTrb5/+cQ9/evUvhF/+j7ZZwe/4HQfvxzDfr87R+E/3EQHPyCicr1dM4++"
    "8aBPv7OHlz+yVGQ+4macPgEx1j0i0XS/L/7QPj+icb8o/02/dbEfP9pxJj9ElXg8WJy/vtaDRL9s4II/a78RwA=="
)


def unit_normals() -> np.ndarray:
    """(256, 2, 2) float32."""
    return np.frombuffer(base64.b64decode(_B64), dtype="<f4").reshape(N_TESTS, 2, 2).copy()
