// chi-squared test (iDASH) — behavioral arithmetic, HELM processed form
// alpha=(4 n0 n2 - n1^2)^2; beta1=2(2 n0+n1)^2; beta2=(2 n0+n1)(2 n2+n1);
// beta3=2(2 n2+n1)^2  (reference README.md:116-137 recipe)
module chi_squared(n0, n1, n2, alpha, beta1, beta2, beta3);
  input [31:0] n0, n1, n2;
  output [31:0] alpha, beta1, beta2, beta3;
  wire t0, t1, t2, t3, t4, t5, t6, t7, t8, t9;

  mult m0(n0, n2, t0);
  mult m1(t0, 4, t1);
  mult m2(n1, n1, t2);
  sub s0(t1, t2, t3);
  mult m3(t3, t3, alpha);
  mult m4(n0, 2, t4);
  add a0(t4, n1, t5);
  mult m5(t5, t5, t6);
  mult m6(t6, 2, beta1);
  mult m7(n2, 2, t7);
  add a1(t7, n1, t8);
  mult m8(t5, t8, beta2);
  mult m9(t8, t8, t9);
  mult m10(t9, 2, beta3);
endmodule
